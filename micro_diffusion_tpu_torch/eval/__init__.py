"""The evaluation path of the port: FID (fid.py, inception.py), GenEval
(geneval.py) and the image generation they score (generate_eval_images.py)."""

__all__ = ["FIDStats", "frechet_distance", "compute_fid_from_stats"]


def __getattr__(name):
    """Lazy exports, so that ``python -m micro_diffusion_tpu_torch.eval.fid`` does not
    find its module imported already by the package."""
    if name in __all__:
        from . import fid

        return getattr(fid, name)
    raise AttributeError(name)
