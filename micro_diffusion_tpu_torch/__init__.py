"""micro_diffusion_tpu_torch: the PyTorch and CUDA port of micro_diffusion_tpu for
one NVIDIA H100.

It turns prompts into images (the CLIP or T5 text encoder, EDM Heun sampling with
classifier-free guidance, the VAE decode) and runs the training step on
precomputed latents (masked EDM loss, AdamW, clipping, EMA); attention, the EC-MoE
expert feed-forward and the fused adaLN, forward and backward, run as hand-written
Hopper kernels. It imports no JAX and nothing of micro_diffusion_tpu.

Layout:
    models/  - DiT backbone (layers.py, dit.py), EDM loss and sampling wrapper
               (diffusion.py), the frozen text encoders (text_encoders.py) and VAE
               (vae.py), weight interop with JAX params and .pt files
    ops/     - attention dispatch, flash attention and fused MoE FFN autograd
               wrappers, token masking
    train/   - schedules, AdamW and EMA (optim.py), the train step (train_step.py)
    utils/   - the CLIP BPE and T5 SentencePiece tokenizers, in pure Python
    csrc/    - the CUDA kernels, built with nvcc at first use (ops/_build.py)
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (keeps bare `import micro_diffusion_tpu_torch` light)."""
    if name in ("create_latent_diffusion", "LatentDiffusion"):
        from .models import diffusion

        return getattr(diffusion, name)
    if name in ("DiT", "MicroDiT_Tiny_2", "MicroDiT_XL_2", "MicroDiT_Micro_2"):
        from .models import dit

        return getattr(dit, name)
    raise AttributeError(name)
