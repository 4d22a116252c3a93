"""Command-line entry points of the port (python -m
smoothquant_tpu_torch.cli.<name>); each runs on the card unless given
--device cpu."""
