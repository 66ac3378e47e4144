"""ocs2_tpu_torch — PyTorch/CUDA port of ocs2_tpu.

Mirrors the ``ocs2_tpu`` package module for module (``core/``, ``oc/``,
``ops/``, ``solvers/``, ``models/``), so the counterpart of a module is found
by path.  Imports ``torch`` and ``numpy`` only.

Conventions of the port:

* float32 tensors; every constructor and entry point takes ``device=`` and
  defaults to ``"cuda"`` (pass ``device="cpu"`` to run on the host).
* Solver-level functions carry an explicit leading batch dimension ``B`` in
  place of ``jax.vmap`` over whole solves; ``params`` is shared by all
  scenarios of a batch.
* Problem callables (dynamics, costs, constraints) are batch-polymorphic:
  they take ``x [..., nx]``, ``u [..., nu]`` and work both on one sample under
  ``torch.func`` transforms and on whole batches in rollouts.
* Hand-written CUDA kernels live in ``csrc/`` and are built at first use into
  ``build/``; nothing is compiled when a module is imported.
"""

__version__ = "0.1.0"
