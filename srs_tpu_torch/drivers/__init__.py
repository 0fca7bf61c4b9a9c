"""The drivers of the port: one module per reference script under
``scripts/``, under the same file name, each runnable as ``python -m
srs_tpu_torch.drivers.<name>``.

- (a) the full-width path: ``proof_200mp`` (the 200MP 16-bit proof),
  ``quality_bench`` (the whole pipeline per provider against a known HR);
- (b) training: ``pretrain``, ``train_polish``, ``train_cond``,
  ``train_lpips``, ``fit_fusion``, ``fit_qa_models``, ``train_ark``;
- (c) evaluation: ``photo_eval`` (the held-out photo panel), ``reeval``,
  ``routed_panel``, ``cond_panel``, ``eval_ark``, ``gen_quality``.

Each keeps its reference's flags and printed lines, runs on the card by
default (for the CPU ``--cpu`` where the reference has that flag, else
``--device cpu``; no silent fallback) and exposes ``main(argv=None)``,
which returns its report. None writes into the JAX package: checkpoints go to
``--checkpoint-dir`` / the output directory, by default
``~/.cache/srs_tpu_torch/models``, as ``.pt`` state dicts
(``models/train.save_checkpoint``), EVAL.json beside them
(``models/evaljson.update_eval``), and the QA fits to
``~/.cache/srs_tpu_torch/qa``. A driver that needs photographs no
installed package ships raises ``models.photo_data.PhotoDataMissing``.
"""
