"""The port's counterparts of the JAX project's ``scripts/`` tools, under the same
names: ``overfit_proof`` (the learning proof), ``trace_summary`` (device time by
kernel and by op class, the role of ``xplane_summary.py`` and
``xplane_categories.py``) and ``attribute_trace`` (device time by model component).
Run each as ``python -m micro_diffusion_tpu_torch.scripts.<name>``; importing one
runs nothing.
"""
