"""Command-line entry points (``python -m repro_torch.launch.<name>``: serve,
train, cluster_dryrun, the LM dry run ``dryrun`` and its ``sweep``), the
device meshes and their stand-in (``mesh.py``), and the roofline models
of the LM step and the ELL kernels (``roofline.py``)."""
