"""The scheduler stack of the PyTorch port.

``events``, ``workload``, ``predictor``, ``machine``, ``policies``,
``executor``, ``metrics`` and ``scheduler_service`` are verbatim copies of
their namesakes in the JAX package (they hold no framework code; the tests
hold each copy to its original).  ``jobs`` is the port's own: it wraps the
PyTorch model as schedulable serving jobs.

Unlike the reference package's ``__init__`` this one re-exports nothing and
imports no submodule, so ``import repro_torch.core.executor`` loads only the
executor's own import closure.
"""
