"""Dataset preparation in the port: the latent precompute (image MDS -> caption and
VAE latents) with its shared helpers and per-dataset specs. The download and convert
pipelines hold no JAX and run from the JAX package as they are (README.md, 'Not
ported')."""
