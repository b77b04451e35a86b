"""CLI: convert a reference torch checkpoint (.pt) into the JAX package's params file
(.npz), or validate that it loads into the port's DiT of a given architecture. The
port of micro_diffusion_tpu/models/convert_checkpoint.py.

    python -m micro_diffusion_tpu_torch.models.convert_checkpoint \\
        --checkpoint MicroDiT_XL_2.pt --dit_arch MicroDiT_XL_2 --out params.npz

The released HF checkpoints (VSehwag24/MicroDiT, reference README.md:55-61) are plain
``dit.state_dict()`` files; Composer trainer checkpoints (state/model nesting) are also
accepted (``interop.load_torch_checkpoint`` handles both). ``--out`` writes the JAX
CLI's file: one float32 array per flax leaf, keyed by the "/"-joined path of the
``{'params': ...}`` tree in its flattening order (dict keys sorted at every level).
``--validate`` builds ``--dit_arch`` on the meta device (no weights are allocated) and
loads the checkpoint into it with ``strict=True``: a missing, extra or mis-shaped
tensor raises. Needs no card.
"""

import argparse
import warnings
from typing import Any, Dict

import numpy as np

from . import dit as model_zoo
from .interop import load_torch_checkpoint, torch_state_dict_to_params


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested params dict as {"a/b/kernel": array}, in jax.tree_util's order."""
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            flat.update(flatten_params(tree[key], path))
        else:
            flat[path] = np.asarray(tree[key])
    return flat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dit_arch", default="MicroDiT_XL_2")
    p.add_argument("--latent_res", type=int, default=32)
    p.add_argument("--in_channels", type=int, default=4)
    p.add_argument("--caption_channels", type=int, default=1024)
    p.add_argument("--out", default=None, help="write converted params (.npz)")
    p.add_argument("--validate", action="store_true",
                   help="check structure/shapes against the target architecture")
    args = p.parse_args(argv)

    state_dict = load_torch_checkpoint(args.checkpoint)
    flat = flatten_params({"params": torch_state_dict_to_params(state_dict)})
    n_params = sum(int(v.size) for v in flat.values())
    print(f"loaded {len(flat)} tensors, {n_params / 1e6:.1f}M params")

    if args.validate:
        model = getattr(model_zoo, args.dit_arch)(
            input_size=args.latent_res,
            in_channels=args.in_channels,
            caption_channels=args.caption_channels,
            device="meta",
        )
        with warnings.catch_warnings():  # copies into meta tensors are no-ops by design
            warnings.filterwarnings("ignore", message=".*meta parameter.*")
            model.load_state_dict(state_dict, strict=True)
        print(f"structure matches {args.dit_arch} exactly")

    if args.out:
        np.savez(args.out, **flat)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
