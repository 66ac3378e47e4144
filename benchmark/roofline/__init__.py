"""A kernel's operations and bytes from its shapes, one module a kernel
(``<kernel>.py``: ``KERNEL`` the fragment of its name in a device trace,
``COUNTER_MODULE`` the program module whose ``last_launch_dims`` gives the
shapes of its last launch, ``work(*dims) -> (flops, bytes)``), and the
card's peaks in ``peaks.json``.  Each input is counted read once and each
output written once; the least time is the larger of flops over the float32
rate and bytes over the memory rate."""
