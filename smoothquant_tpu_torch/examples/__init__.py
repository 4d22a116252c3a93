"""Runnable examples of the port: `python -m smoothquant_tpu_torch.examples.<name>`
(serving_demo, opt_demo, cluster_demo), each on the card unless given
--device cpu."""
