"""Seconds per image of fusion's dihedral-ensemble members (``edsr_xl+``,
``edsr_l+``) over every ladder step: each member's device span
``device/super_resolution/<member>@x<scale>`` (a CUDA event pair), else
its host span, from ``PipelineResult.spans``, averaged over the window's
images."""

from yardstick.program import ensemble_seconds, job_mean


def read(run):
    return job_mean(run, ensemble_seconds)
