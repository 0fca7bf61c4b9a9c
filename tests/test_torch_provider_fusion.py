"""Port parity: ``process()`` with the ``fusion`` provider against the JAX
package's pipeline, as tests/test_torch_provider_pipeline.py runs it (a
32x48 input to 96x64, two 32-px tiles, float32 convolutions, the
packaged checkpoints converted): the packaged x2 members, and a fusion
with fewer than two trained members, which serves the quality net.

Tolerance: at most 1 LSB, on under 1% of samples (fusion's weights, up
to 1.65 in magnitude, scale the members' float32 differences).
"""

from test_torch_provider_pipeline import image, run_both  # noqa: F401 - the fixture
from test_torch_providers import X2_MEMBERS


def test_fusion_x2_with_the_packaged_members(image, tmp_path, monkeypatch):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [(m, 2) for m in X2_MEMBERS], 2, provider="fusion")
    info = pipe.last_run_info
    assert info["provider"] == info["requested_provider"] == "fusion"
    assert info["step_members"] == jpipe.last_run_info["step_members"] == [[
        ["edsr_xl", 8], ["edsr_l", 8], ["edsr_xl", 1], ["edsr_l", 1], ["rcan", 1],
        ["edsr_m", 1], ["espcn", 1]]]


def test_fusion_without_two_trained_members_serves_quality_and_says_so(
        image, tmp_path, monkeypatch):
    _, jpipe, _, pipe = run_both(image, tmp_path, monkeypatch,
                                 [("edsr_m", s) for s in (2, 3, 4)], 2, provider="fusion")
    info = pipe.last_run_info
    assert info["requested_provider"] == "fusion" and info["provider"] == "quality"
    assert info["step_members"] == [[["edsr_m", 1]]]
    assert jpipe.last_run_info["provider"] == "fusion"  # the reference's label
