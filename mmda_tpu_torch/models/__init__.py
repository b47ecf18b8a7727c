"""Model registry of the port (counterpart of `mmda_tpu/models/__init__.py`).

MISA and the first four families of the JAX zoo: EF_LSTM, LF_DNN, LMF and
TFN.  MULT, MAG_BERT and MMIM are still to come (ROADMAP Queue 1).  Every
family is an `nn.Module` built as `cls(cfg, visual_size=, acoustic_size=,
vocab_size=, bert_cfg=, device=)`, seeded by `reset_parameters(generator)`,
and called as `model(batch, modality_keep, recurrence, generator)`,
returning a `MISAOutput`.
"""

from mmda_tpu_torch.models.ef_lstm import EF_LSTM
from mmda_tpu_torch.models.lf_dnn import LF_DNN
from mmda_tpu_torch.models.lmf import LMF
from mmda_tpu_torch.models.misa import MISA, Batch, MISAOutput, init_misa, misa_forward
from mmda_tpu_torch.models.tfn import TFN

_REGISTRY = {"MISA": MISA, "EF_LSTM": EF_LSTM, "LF_DNN": LF_DNN, "LMF": LMF, "TFN": TFN}


def get_model(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")


__all__ = ["Batch", "EF_LSTM", "LF_DNN", "LMF", "MISA", "MISAOutput", "TFN", "get_model",
           "init_misa", "misa_forward"]
