from diagan_tpu_torch.utils.settings import set_seed

__all__ = ["set_seed"]
