"""Shared by the port's tests: where both packages look for their packaged
weights.

The reference reads its packaged orbax checkpoints from
``srs_tpu.models.registry.PACKAGED_CHECKPOINT_DIR``; the port reads its
store (float32 state dicts, the ledgers and ``MANIFEST.json``) from
``srs_tpu_torch.models.registry.PACKAGED_CHECKPOINT_DIR``. A test that
holds the two packages' untrained nets, or the nets it names, against
each other points both at a directory of its own with
:func:`packaged_in`; one that needs the reference's packaged nets and the
port's store hidden uses :func:`port_store_in`.
"""

import srs_tpu.models.registry as jax_registry
import srs_tpu_torch.models.registry as port_registry


def packaged_in(monkeypatch, path):
    """For the rest of the test both packages read their packaged weights
    from ``path``: the reference's checkpoint directories there, and the
    port's store as its ``MANIFEST.json`` there lists it (none: an empty
    store, every net untrained unless handed in or saved, LPIPS on seeded
    features). The packaged ledgers stay where they are on both sides."""
    monkeypatch.setattr(jax_registry, "PACKAGED_CHECKPOINT_DIR", str(path))
    port_store_in(monkeypatch, path)


def port_store_in(monkeypatch, path):
    """For the rest of the test the port reads its store from ``path``
    alone (an empty store where ``path`` has no ``MANIFEST.json``)."""
    monkeypatch.setattr(port_registry, "PACKAGED_CHECKPOINT_DIR", str(path))
