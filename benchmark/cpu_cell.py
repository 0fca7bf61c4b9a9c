"""A small cell for the CPU tests: the default path's flags at a toy size
(a 144x256 input to 9x on tiles of 128, the fast net on both x3 steps,
per-scale selection off), so a run drives every stage of the program and
of the reference in seconds. Never a benchmark cell."""

# The QA report's keys with QA on and no ROIs: the full-reference values
# and levels, the no-reference ones on the input-size proxy, and those
# over the full-resolution crops.
QA_KEYS = ["brisque", "brisque_level", "colorfulness", "contrast", "fullres_brisque",
           "fullres_contrast", "fullres_crops", "fullres_niqe", "fullres_sharpness", "lpips_alex",
           "lpips_level", "lpips_vgg", "ms_ssim", "niqe", "niqe_level", "overall_score", "psnr",
           "psnr_high_frequency", "psnr_level", "psnr_mid_frequency", "psnr_structure_color",
           "sharpness", "ssim", "ssim_high_frequency", "ssim_level", "ssim_mid_frequency",
           "ssim_structure_color"]

CONFIG = {
    "name": "cpu-toy",
    "pipeline": {"block_size": 128, "overlap_ratio": 0.2, "target_resolution": "2304x1296",
                 "provider": "quality", "quality_model": "espcn", "per_scale_selection": False,
                 "auto_route": True, "ibp_steps": 4, "bit_depth": 8, "enable_qa": True,
                 "compute_dtype": "bfloat16", "params_dtype": "float32"},
    "route": {"provider": "quality", "model": None, "ladder": [3, 3],
              "steps": [[["espcn", 1]], [["espcn", 1]]], "tiles": 6, "block": 128},
    "nets": {"espcn": {"kind": "espcn", "features": 64, "channels": 3}},
    "reduced": [], "assumed": [],
    # Set from the toy's own readings on the CPU (seeds 5-7, the worst
    # over both checked jobs): the program 0.0135 LSB, 0.133 dB, SSIM
    # 2.3e-5, MS-SSIM 6.2e-6, LPIPS vgg 5.1e-5, alex 1.9e-5; half of the
    # tiles left out 0.057 LSB; LPIPS at half resolution 8.4e-4 (vgg) and
    # 2.7e-4 (alex); SSIM on every second pixel 1.6e-4.
    "check": {"tiff_mean_abs_lsb": 0.03, "qa_psnr_gap_db": 0.5, "qa_ssim_gap": 7e-5,
              "qa_ms_ssim_gap": 3e-5, "qa_lpips_vgg_gap": 2e-4, "qa_lpips_alex_gap": 1e-4,
              "probe_gain_gap_db": 0.1, "probe_alpha_gap": 0.05},
    "qa_keys": QA_KEYS,
}
TRAFFIC = {"name": "cpu-toy", "entry": "process_batch", "jobs_per_call": 2, "workers": 2,
           "check_jobs": [[0, 0], [1, 1]],
           "input": {"size": 256, "rows": [56, 200], "pool": [2, 21, 9]}}
CELL = {"name": "cpu-toy", "config": "cpu-toy", "traffic": "cpu-toy", "chips": 1}
END_TO_END = [{"name": n, "unit": u} for n, u in
              (("mp_per_s", "MP/s"), ("peak_gib", "GiB"), ("tiff_bytes_per_px", "B/px"),
               ("setup_s", "s"))]

# The toy with seeded weights in place of the store's trained espcn: drawn
# by ``yardstick/weights.py`` and handed to the program as a
# ``checkpoint_dir``. Unrouted: a random net loses to bicubic, so the
# SR-gain probe would shrink it.
SEEDED_CONFIG = {
    **CONFIG, "name": "cpu-toy-seeded",
    "pipeline": {**CONFIG["pipeline"], "auto_route": False},
    "nets": {"espcn": {**CONFIG["nets"]["espcn"], "weights": {"seed": 11}}},
}
