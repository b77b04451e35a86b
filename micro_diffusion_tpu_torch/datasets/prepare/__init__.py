"""Dataset preparation in the port, from raw files to latents: the download
(``download``) and convert pipelines (``convert`` and the six datasets' modules
``jdb``, ``diffdb``, ``cc12m``, ``sa1b``, ``textcaps``, ``coco``), which write the
image MDS, and the latent precompute (image MDS -> caption and VAE latents), with
their shared helpers (``common``) and per-dataset specs (``specs``). One command
runs them in order: micro_diffusion_tpu_torch/get_dataset.sh."""
