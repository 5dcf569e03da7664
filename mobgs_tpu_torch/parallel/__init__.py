"""Scale-out: the data x gauss mesh over ``torch.distributed``."""
from mobgs_tpu_torch.parallel import mesh  # noqa: F401
