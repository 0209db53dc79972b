from swtpu_torch.utils.device import as_codes, resolve_device  # noqa: F401
from swtpu_torch.utils.timing import time_kernel  # noqa: F401
