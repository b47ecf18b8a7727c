"""Model registry of the port (counterpart of `mmda_tpu/models/__init__.py`).

MISA and the rest of the JAX zoo: EF_LSTM, LF_DNN, MULT, LMF, TFN, MAG_BERT
and MMIM, the eight families the JAX registry names.  Every family is an
`nn.Module` built as `cls(cfg, visual_size=, acoustic_size=, vocab_size=,
bert_cfg=, device=)`, seeded by `reset_parameters(generator)`, and called
as `model(batch, modality_keep, recurrence, generator)`, returning a
`MISAOutput`.
"""

from mmda_tpu_torch.models.ef_lstm import EF_LSTM
from mmda_tpu_torch.models.lf_dnn import LF_DNN
from mmda_tpu_torch.models.lmf import LMF
from mmda_tpu_torch.models.mag_bert import MAG_BERT
from mmda_tpu_torch.models.misa import MISA, Batch, MISAOutput, init_misa, misa_forward
from mmda_tpu_torch.models.mmim import MMIM
from mmda_tpu_torch.models.mult import MULT
from mmda_tpu_torch.models.tfn import TFN

_REGISTRY = {"MISA": MISA, "EF_LSTM": EF_LSTM, "LF_DNN": LF_DNN, "MULT": MULT, "LMF": LMF,
             "TFN": TFN, "MAG_BERT": MAG_BERT, "MMIM": MMIM}


def get_model(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")


__all__ = ["Batch", "EF_LSTM", "LF_DNN", "LMF", "MAG_BERT", "MISA", "MISAOutput", "MMIM",
           "MULT", "TFN", "get_model", "init_misa", "misa_forward"]
