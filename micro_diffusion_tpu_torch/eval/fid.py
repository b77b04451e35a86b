"""FID evaluation: streaming activation statistics and the Frechet distance, the
port's own copy of micro_diffusion_tpu/eval/fid.py.

  * FIDStats - streaming (mu, Sigma) accumulation over feature batches, float64
    sums on the host (no need to hold 30k activations in memory); ``save`` /
    ``load`` write and read the same ``.npz`` keys as the JAX package, so
    real-side statistics saved by either package load in the other;
  * frechet_distance - ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) through
    scipy's sqrtm;
  * the InceptionV3 pool3 features (eval/inception.py) run on ``--device``: the
    card unless the caller asks for the CPU.

Typical flow (eval/generate_eval_images.py makes the images):
    stats_real = FIDStats.from_batches(feature_fn, real_batches)
    stats_fake = FIDStats.from_batches(feature_fn, fake_batches)
    fid = compute_fid_from_stats(stats_real, stats_fake)
"""

import dataclasses
import json
import os
from typing import Callable, Iterable, Optional

import numpy as np


@dataclasses.dataclass
class FIDStats:
    """Streaming mean/covariance accumulator for feature vectors."""

    dim: int
    n: int = 0
    sum: Optional[np.ndarray] = None
    outer_sum: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.sum is None:
            self.sum = np.zeros(self.dim, np.float64)
        if self.outer_sum is None:
            self.outer_sum = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"features of shape {feats.shape}, expected (n, {self.dim})")
        self.n += feats.shape[0]
        self.sum += feats.sum(axis=0)
        self.outer_sum += feats.T @ feats

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.n, 1)

    @property
    def cov(self) -> np.ndarray:
        mu = self.mean
        return (self.outer_sum - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)

    @classmethod
    def from_batches(cls, feature_fn: Callable, batches: Iterable[np.ndarray]) -> "FIDStats":
        stats = None
        for batch in batches:
            feats = np.asarray(feature_fn(batch))
            if stats is None:
                stats = cls(dim=feats.shape[1])
            stats.update(feats)
        if stats is None:
            raise ValueError("no batches")
        return stats

    def save(self, path: str) -> None:
        np.savez(path, n=self.n, sum=self.sum, outer_sum=self.outer_sum)

    @classmethod
    def load(cls, path: str) -> "FIDStats":
        z = np.load(path)
        return cls(dim=int(z["sum"].shape[0]), n=int(z["n"]), sum=z["sum"],
                   outer_sum=z["outer_sum"])


def _sqrtm_quiet(a: np.ndarray) -> np.ndarray:
    """scipy's sqrtm without its printed warning: ``disp=False`` where scipy still
    takes it (the JAX package's call); newer scipy dropped ``disp`` and never prints."""
    import inspect

    from scipy import linalg

    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Standard FID Frechet distance (Heusel et al.): when sqrtm of the product is
    not finite, retry with ``eps`` on both diagonals; keep the real part."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = _sqrtm_quiet(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def compute_fid_from_stats(real: FIDStats, fake: FIDStats) -> float:
    return frechet_distance(real.mean, real.cov, fake.mean, fake.cov)


def load_inception_feature_fn(weights_path: str, device=None) -> Callable:
    """InceptionV3 pool3 features from local pt_inception-2015-12-05 weights (the
    canonical FID feature space) on ``device`` (the card when None).

    Returns feature_fn(images (B, 3, H, W) float in [0, 1]) -> (B, 2048) numpy.
    """
    from .inception import load_params, make_feature_fn

    return make_feature_fn(load_params(weights_path), device=device)


def iter_image_dir_batches(image_dir: str, batch_size: int = 32, limit: Optional[int] = None):
    """Yield (B, 3, H, W) float32 [0, 1] batches from a directory of images (the
    output of eval/generate_eval_images.py, or a real-image reference set): each
    image centre-cropped to a square, then resized to 299 (PIL bilinear) unless it
    is 299 already."""
    from PIL import Image

    names = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    if limit:
        names = names[:limit]
    buf = []
    for name in names:
        img = Image.open(os.path.join(image_dir, name))
        if img.mode != "RGB":
            img = img.convert("RGB")
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s))
        if s != 299:
            img = img.resize((299, 299), Image.BILINEAR)
        buf.append(np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def main(argv=None):
    """FID between two image directories (or a directory and precomputed .npz stats):

    python -m micro_diffusion_tpu_torch.eval.fid --real <dir|stats.npz> --fake <dir> \
        --inception_weights pt_inception-2015-12-05.pth [--save_real_stats out.npz] \
        [--device cuda|cpu]
    """
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--real", required=True, help="image dir or FIDStats .npz")
    p.add_argument("--fake", required=True, help="image dir or FIDStats .npz")
    p.add_argument("--inception_weights", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None, help="cap image count (30k)")
    p.add_argument("--save_real_stats", default=None,
                   help="save the real-side stats for reuse across runs")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                   "card) or cpu")
    args = p.parse_args(argv)

    feature_fn = load_inception_feature_fn(args.inception_weights, device=args.device)

    def stats_for(path: str) -> FIDStats:
        if path.endswith(".npz"):
            return FIDStats.load(path)
        return FIDStats.from_batches(feature_fn,
                                     iter_image_dir_batches(path, args.batch_size, args.limit))

    real = stats_for(args.real)
    if args.save_real_stats:
        real.save(args.save_real_stats)
    fake = stats_for(args.fake)
    fid = compute_fid_from_stats(real, fake)
    print(json.dumps({"fid": round(fid, 4), "real_n": real.n, "fake_n": fake.n}))
    return fid


if __name__ == "__main__":
    main()
