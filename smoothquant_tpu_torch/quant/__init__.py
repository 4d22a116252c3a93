from smoothquant_tpu_torch.quant.config import QuantConfig, w4a4_group, w4a8_group

__all__ = ["QuantConfig", "w4a4_group", "w4a8_group"]
