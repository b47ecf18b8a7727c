"""Model registry of the port (counterpart of `mmda_tpu/models/__init__.py`).

Only MISA is ported so far; the rest of the JAX model zoo is still to come.
"""

from mmda_tpu_torch.models.misa import MISA, Batch, MISAOutput, init_misa, misa_forward

_REGISTRY = {"MISA": MISA}


def get_model(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")


__all__ = ["Batch", "MISA", "MISAOutput", "get_model", "init_misa",
           "misa_forward"]
