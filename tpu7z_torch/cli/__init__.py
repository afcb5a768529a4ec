"""The port's command line, `python -m tpu7z_torch.cli` (see main.py)."""
