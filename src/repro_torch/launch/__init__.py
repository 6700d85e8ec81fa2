"""Command-line drivers (``python -m repro_torch.launch.<name>``) and the
ELL kernels' roofline model (``roofline.py``)."""
