"""The port's copy of dynseg/sched (host-side numpy)."""
from dynseg_torch.sched.scheduler import ScaleScheduler  # noqa: F401
