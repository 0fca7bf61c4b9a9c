"""Port parity: per-scale selection and the EVAL.json ledger
(srs_tpu_torch.models.selection, .evaljson, .sr_module) against the JAX
reference. The port reads the packaged ledger by path; a net counts as
trained in the port when weights are handed in for it, here exactly the
nets for which the reference's ``is_pretrained`` says trained.
"""

import json
import os

import pytest

from srs_tpu.config import ModelConfig as RModelConfig
from srs_tpu.models import evaljson as RE
from srs_tpu.models import selection as RS
from srs_tpu.models.registry import is_pretrained
from srs_tpu.models.sr_module import SuperResolutionModule as RSR
from srs_tpu_torch.config import ModelConfig
from srs_tpu_torch.models import evaljson as TE
from srs_tpu_torch.models import registry
from srs_tpu_torch.models import selection as TS
from srs_tpu_torch.models.registry import seeded_params
from srs_tpu_torch.models.sr_module import SuperResolutionModule

CKPT = RE.packaged_eval_dir(None)


def _reference_trained(name, scale):
    return is_pretrained(name, scale)


def test_packaged_ledger_is_read_by_path():
    # the port's packaged ledger is the store's copy of the reference's
    assert os.path.realpath(TE.packaged_eval_dir()) == os.path.realpath(
        registry.PACKAGED_CHECKPOINT_DIR)
    assert TE.load_eval(TE.packaged_eval_dir()) == RE.load_eval(CKPT)
    assert TS.QUALITY_CANDIDATES == RS.QUALITY_CANDIDATES


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_panel_best_model_matches_reference(scale):
    ref = RS.panel_best_model(scale, "edsr_xl", CKPT)
    got = TS.panel_best_model(scale, "edsr_xl", _reference_trained)
    # the panel: edsr_l wins x2, edsr_xl x3 and x4
    assert got == ref == ("edsr_l" if scale == 2 else "edsr_xl")


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_panel_best_model_skips_nets_without_weights(scale):
    """Without edsr_l's weights the x2 step keeps edsr_xl; without any
    trained candidate the default stands."""
    only_xl = lambda n, s: n == "edsr_xl"  # noqa: E731
    assert TS.panel_best_model(scale, "edsr_xl", only_xl) == "edsr_xl"
    assert TS.panel_best_model(scale, "edsr_m", lambda n, s: False) == "edsr_m"


def test_panel_best_falls_back_without_evidence(tmp_path):
    with open(os.path.join(tmp_path, "EVAL.json"), "w") as f:
        json.dump({"edsr_l_x2": {"psnr_net": 30.0}}, f)
    d = str(tmp_path)
    assert TS.panel_best_model(2, "edsr_xl", lambda n, s: True, d) \
        == RS.panel_best_model(2, "edsr_xl", d) == "edsr_xl"


def test_ledger_in_checkpoint_dir_comes_first(tmp_path):
    """A directory's own ledger wins over the packaged one: the card's
    smoke points checkpoint_dir at a ledger it writes."""
    with open(os.path.join(tmp_path, "EVAL.json"), "w") as f:
        json.dump({"edsr_m_x3": {"photo_panel": {"mean_delta": 5.0}},
                   "edsr_xl_x3": {"photo_panel": {"mean_delta": 0.971}}}, f)
    assert TS.panel_best_model(3, "edsr_xl", lambda n, s: True, str(tmp_path)) == "edsr_m"


def test_sr_module_resolves_mixed_ladder_like_reference():
    names = ("edsr_xl", "edsr_l")
    weights = {(n, s): seeded_params("edsr_m", 2) for n in names for s in (2, 3, 4)
               if _reference_trained(n, s)}
    ref = RSR(config=RModelConfig(quality_model="edsr_xl", checkpoint_dir=CKPT,
                                  per_scale_selection=True))
    sr = SuperResolutionModule(ModelConfig(quality_model="edsr_xl"), weights, device="cpu")
    assert sr.resolve_ladder_models([2, 3, 4]) \
        == ref.resolve_ladder_models([2, 3, 4], "quality") == ["edsr_l", "edsr_xl", "edsr_xl"]
    assert sr.resolve_ladder_models([2, 2], model="edsr_l_robust") == ["edsr_l_robust"] * 2
    assert sr.trained_scales() == {2, 3, 4}
    off = SuperResolutionModule(ModelConfig(quality_model="edsr_xl", per_scale_selection=False),
                                weights, device="cpu")
    assert off.resolve_ladder_models([2, 3]) == ["edsr_xl", "edsr_xl"]
