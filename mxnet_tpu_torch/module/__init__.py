"""``mx.mod``: the Module API (port of ``mxnet_tpu/module``).
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` wait for
the word-LM slice (ROADMAP Queue 1)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401

__all__ = ["BaseModule", "Module"]
