"""Native real-time runtime: policy transport, rate loops, serialization.

Counterpart of ``ocs2_tpu/runtime``: the port keeps its own copy of the
ctypes binding of ``native/ocs2rt.cpp`` (``native.py``) and of the policy
flattening (``serialization.py``); both are framework-free.
"""
