"""Plain PyTorch references of published models, written apart from the\nport: each imports nothing of ``repro_torch`` and no kernel."""
