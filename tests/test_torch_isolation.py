"""The port stands alone: `mmda_tpu_torch` and `chip_smoke.py` import no JAX
and nothing of `mmda_tpu`, entry points never run on the CPU unless asked,
and the kernel wrappers have no fallback from a CUDA tensor to the plain
version."""

import ast
import inspect
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import mmda_tpu_torch
from mmda_tpu_torch.ops.kernels import _launch
from mmda_tpu_torch.ops.kernels import attention as kattn
from mmda_tpu_torch.ops.kernels import gru as kgru
from mmda_tpu_torch.ops.kernels import hash_dropout
from mmda_tpu_torch.ops.kernels import layernorm as kln
from mmda_tpu_torch.ops.kernels import lstm as klstm
from mmda_tpu_torch.ops.kernels import lstm_multi as kmulti
from mmda_tpu_torch.ops.kernels import short_attention as kshort

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(mmda_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmda_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        name = ".".join(rel.parts)
        yield name[: -len(".__init__")] if name.endswith(".__init__") else name


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import_in_source(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


def test_every_module_imports_with_jax_and_mmda_tpu_blocked():
    """A fresh interpreter where importing jax, flax, optax or mmda_tpu
    fails imports every module of the port and chip_smoke.py."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None        # any import of it raises
        for name in {list(_modules())!r}:
            importlib.import_module(name)
        sys.path.insert(0, {str(ROOT)!r})
        import chip_smoke
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


def test_entry_points_raise_without_cuda_instead_of_using_the_cpu(monkeypatch):
    from mmda_tpu_torch.config import Config, resolve_device
    from mmda_tpu_torch.serving import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Config().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(Config(use_bert=False, hidden_size=8), params=None)
    assert resolve_device("cpu").type == "cpu"


def test_the_parallel_package_is_covered(monkeypatch, tmp_path):
    """The data-parallel modules are among those the checks above read and
    import; their entry point asks for the card by default and raises
    without one instead of running its ranks on the CPU."""
    from mmda_tpu_torch.parallel.mesh import init_distributed

    assert {"mmda_tpu_torch.parallel", "mmda_tpu_torch.parallel.mesh"} <= set(_modules())
    assert PKG / "parallel" / "mesh.py" in set(PKG.rglob("*.py"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(rank=0, world_size=1, init_method=f"file://{tmp_path / 'store'}")


def test_chip_smoke_fails_without_cuda():
    """No card: a non-zero exit and no result line."""
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_wrapper_has_no_fallback():
    """lstm_recurrence takes the plain version only for a CPU tensor: it
    calls the `mmda_tpu_torch::lstm_recurrence` op, whose implementation
    (`_forward`, where the route is taken) holds no try/except, and every
    other device either launches the kernel or raises."""
    assert "environ" not in inspect.getsource(klstm)      # no routing switch
    assert "lstm_recurrence_op(" in inspect.getsource(klstm.lstm_recurrence)
    src = inspect.getsource(klstm._forward)
    tree = ast.parse(textwrap.dedent(src))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "lstm_recurrence_reference"]
    assert len(calls) == 1
    x = torch.zeros(2, 2, 8, device="meta")
    w = torch.zeros(2, 8, device="meta")
    m = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        klstm.lstm_recurrence(x, w, m)


def test_bwd_kernel_wrapper_has_no_fallback():
    """The same for lstm_recurrence_bwd, the BPTT kernel's wrapper (and so
    for the LSTMRecurrence backward that calls it)."""
    src = inspect.getsource(klstm.lstm_recurrence_bwd)
    tree = ast.parse(textwrap.dedent(src))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "lstm_recurrence_bwd_reference"]
    assert len(calls) == 1
    assert "lstm_recurrence_bwd(" in inspect.getsource(klstm.LSTMRecurrence.backward)
    T, B, H = 2, 2, 2
    args = [torch.zeros(s, device="meta") for s in
            [(T, B, 4 * H), (H, 4 * H), (T, B), (T, B, H), (T, B, H), (T, B, H), (B, H)]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        klstm.lstm_recurrence_bwd(*args)


def _meta(*shapes, dtype=torch.float32):
    return [torch.zeros(s, device="meta", dtype=dtype) for s in shapes]


T_, B_, H_ = 2, 2, 2
NEW_WRAPPERS = {
    "gru_recurrence": (kgru, "gru_recurrence_reference",
                       lambda: _meta((T_, B_, 3 * H_), (H_, 3 * H_), (3 * H_,), (T_, B_)),
                       "_forward"),
    "gru_recurrence_bwd": (kgru, "gru_recurrence_bwd_reference",
                           lambda: _meta((T_, B_, 3 * H_), (H_, 3 * H_), (3 * H_,), (T_, B_),
                                         (T_, B_, H_), (T_, B_, H_), (B_, H_))),
    "residual_dropout_layernorm_fwd": (kln, "residual_dropout_layernorm_reference",
                                       lambda: _meta((4, 8), (4, 8), (8,), (8,)) + [None]),
    "residual_dropout_layernorm_bwd": (kln, "residual_dropout_layernorm_bwd_reference",
                                       lambda: _meta((4, 8), (4, 8), (8,), (4, 8)) + [None]),
}


@pytest.mark.parametrize("name", sorted(NEW_WRAPPERS))
def test_gru_and_layernorm_wrappers_have_no_fallback(name):
    """Each takes its plain version only for a CPU tensor: no try/except, no
    routing switch, one call of the plain version, and any other device
    either launches the kernel or raises."""
    module, reference, make_args, *routed = NEW_WRAPPERS[name]
    assert "environ" not in inspect.getsource(module)
    if routed:      # an op's wrapper: the route is taken in the op's implementation
        assert f"{name}_op(" in inspect.getsource(getattr(module, name))
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(module, (routed or [name])[0]))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == reference]
    assert len(calls) == 1
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(module, name)(*make_args())
    assert "gru_recurrence_bwd(" in inspect.getsource(kgru.GRURecurrence.backward)
    assert "residual_dropout_layernorm_bwd(" in inspect.getsource(
        kln.ResidualDropoutLayerNorm.backward)


def test_every_cuda_source_has_one_launch_count_and_one_entry_point():
    """`_launch.KERNELS` is the list of csrc/*.cu; each defines its plain C
    entry `mmda_<name>`; the modules' SOURCES partition it; one count each,
    shared by all the modules."""
    csrc = PKG / "csrc"
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(_launch.KERNELS)
    for name in _launch.KERNELS:
        assert f"int mmda_{name}(" in (csrc / f"{name}.cu").read_text()
    assert (sorted(klstm.SOURCES + kgru.SOURCES + kln.SOURCES + kattn.SOURCES
                   + kshort.SOURCES + kmulti.SOURCES) == sorted(_launch.KERNELS))
    assert (klstm.launch_count is kgru.launch_count is kln.launch_count
            is kattn.launch_count is kshort.launch_count is kmulti.launch_count
            is _launch.launch_count)
    _launch.reset_launch_count()
    assert [_launch.launch_count(n) for n in _launch.KERNELS] == [0] * len(_launch.KERNELS)
    with pytest.raises(KeyError):
        _launch.launch_count("no_such_kernel")


def test_hash_constants_are_the_same_in_the_header_and_the_plain_version():
    header = (PKG / "csrc" / "hash_dropout.cuh").read_text()
    plain = inspect.getsource(hash_dropout)
    for const in ("2654435761", "0x9E3779B9", "40503", "0x7FEB352D", "0x846CA68B"):
        assert const in header and const in plain, const
    for kernel in ("ln_dropout_fwd", "ln_dropout_bwd"):
        assert '#include "hash_dropout.cuh"' in (PKG / "csrc" / f"{kernel}.cu").read_text()


BH_, S_, D_ = 2, 8, 16
FLASH_WRAPPERS = {
    "flash_attention_fwd": ("flash_attention_fwd_reference",
                            lambda: _meta((BH_, S_, D_), (BH_, S_, D_), (BH_, S_, D_),
                                          (BH_, S_)) + [None], "_forward"),
    "flash_attention_bwd_dq": ("flash_attention_bwd_dq_reference",
                               lambda: _meta((BH_, S_, D_), (BH_, S_, D_), (BH_, S_, D_),
                                             (BH_, S_)) + [None]
                               + _meta((BH_, S_, D_), (BH_, S_), (BH_, S_))),
    "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv_reference",
                                lambda: _meta((BH_, S_, D_), (BH_, S_, D_), (BH_, S_, D_),
                                              (BH_, S_)) + [None]
                                + _meta((BH_, S_, D_), (BH_, S_), (BH_, S_))),
}


@pytest.mark.parametrize("name", sorted(FLASH_WRAPPERS))
def test_attention_wrappers_have_no_fallback(name):
    """Each takes its plain version only for a CPU tensor: no try/except, no
    routing switch, one call of the plain version, and any other device
    either launches the kernel or raises.  The autograd function's backward
    goes through `flash_attention_bwd`, which does the same for both halves
    (one call of each plain version, one launch of each kernel, on d_out
    rounded once for both), and no wrapper or plain version calls a
    library's attention."""
    reference, make_args, *routed = FLASH_WRAPPERS[name]
    source = inspect.getsource(kattn)
    assert "environ" not in source and "scaled_dot_product_attention" not in source
    if routed:      # an op's wrapper: the route is taken in the op's implementation
        assert f"{name}_op(" in inspect.getsource(getattr(kattn, name))
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(kattn, (routed or [name])[0]))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == reference]
    assert len(calls) == 1
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(kattn, name)(*make_args())
    assert "flash_attention_bwd(" in inspect.getsource(kattn.FlashAttention.backward)
    whole = ast.parse(textwrap.dedent(inspect.getsource(kattn.flash_attention_bwd)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(whole))
    called = [n for n in ast.walk(whole) if isinstance(n, ast.Call)]
    names = [getattr(n.func, "id", None) for n in called]
    assert names.count("flash_attention_bwd_dq_reference") == 1
    assert names.count("flash_attention_bwd_dkv_reference") == 1
    assert sorted(n.args[0].value for n in called
                  if getattr(n.func, "id", None) == "_bwd_launch") == ["flash_bwd_dkv",
                                                                      "flash_bwd_dq"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kattn.flash_attention_bwd(*_meta((BH_, S_, D_), (BH_, S_, D_), (BH_, S_, D_),
                                         (BH_, S_)), None,
                                  *_meta((BH_, S_), (BH_, S_, D_), (BH_, S_, D_)))


Q_ = (2, 2, 8, 16)
SLICE5_WRAPPERS = {
    "short_attention_fwd": (kshort, "short_attention_fwd_reference",
                            lambda: _meta(Q_, Q_, Q_, (2, 8)) + [None], "_forward"),
    "short_attention_bwd": (kshort, "short_attention_bwd_reference",
                            lambda: _meta(Q_, Q_, Q_, (2, 8)) + [None] + _meta(Q_)),
    "lstm_multi_recurrence": (kmulti, "lstm_multi_recurrence_reference",
                              lambda: [_meta((T_, B_, 4 * H_)), _meta((H_, 4 * H_)),
                                       _meta((T_, B_)), [False]]),
    "lstm_multi_recurrence_bwd": (kmulti, "lstm_multi_recurrence_bwd_reference",
                                  lambda: [_meta((T_, B_, 4 * H_)), _meta((H_, 4 * H_)),
                                           _meta((T_, B_)), [False]]
                                  + [_meta(s) for s in ((T_, B_, H_), (T_, B_, H_),
                                                        (T_, B_, H_), (B_, H_))]),
}


@pytest.mark.parametrize("name", sorted(SLICE5_WRAPPERS))
def test_short_attention_and_multi_lstm_wrappers_have_no_fallback(name):
    """Each takes its plain version only for a CPU tensor: no try/except, no
    routing switch, one call of the plain version, and any other device
    either launches the kernel or raises.  The autograd functions' backwards
    go through the backward wrappers, and no short attention code calls a
    library's attention."""
    module, reference, make_args, *routed = SLICE5_WRAPPERS[name]
    source = inspect.getsource(module)
    assert "environ" not in source and "scaled_dot_product_attention" not in source
    if routed:      # an op's wrapper: the route is taken in the op's implementation
        assert f"{name}_op(" in inspect.getsource(getattr(module, name))
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(module, (routed or [name])[0]))))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == reference]
    assert len(calls) == 1
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(module, name)(*make_args())
    assert "short_attention_bwd(" in inspect.getsource(kshort.ShortAttention.backward)
    assert "lstm_multi_recurrence_bwd(" in inspect.getsource(kmulti.LSTMMultiRecurrence.backward)


def test_short_attention_hash_mix_is_in_the_header():
    """The short kernels' own position mix: the same constants in
    hash_dropout.cuh and in the plain version, and every short kernel uses
    it: by calling it, or through short_tiled.cuh's `KeepMask`, which does."""
    header = (PKG / "csrc" / "hash_dropout.cuh").read_text()
    mix = header[header.index("short_attn_base"):]
    plain = inspect.getsource(hash_dropout.short_attention_keep_mask)
    for const in ("2654435761", "40503", "51329"):
        assert const in mix and const in plain, const
    tiled = (PKG / "csrc" / "short_tiled.cuh").read_text()
    keep_mask = tiled[tiled.index("struct KeepMask"):]
    keep_mask = keep_mask[:keep_mask.index("\n};\n")]
    assert "short_attn_base(" in keep_mask and "short_attn_keep(" in keep_mask
    for kernel in kshort.SOURCES:
        src = (PKG / "csrc" / f"{kernel}.cu").read_text()
        assert ("short_attn_base(" in src and "short_attn_keep(" in src) or (
            '#include "short_tiled.cuh"' in src and "KeepMask keep(" in src), kernel


def test_cuda_sources_include_only_the_repo_and_the_toolkit():
    """Every #include of csrc/ names a header beside it or one of the CUDA
    toolkit's / the C library's: no PyTorch, CUTLASS or other package."""
    import re

    csrc = PKG / "csrc"
    local = {p.name for p in csrc.glob("*.cuh")}
    toolkit = {"cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h", "cuda.h", "cstdint", "cstddef",
               "math.h", "cmath", "stdint.h"}
    seen = set()
    for path in sorted(csrc.iterdir()):
        for quote, header in re.findall(r'#include\s*([<"])([^>"]+)[>"]', path.read_text()):
            assert header in (local if quote == '"' else toolkit), f"{path.name}: {header}"
            seen.add(header)
    assert "flash_common.cuh" in seen and "hash_dropout.cuh" in seen
    for kernel in kattn.SOURCES:
        assert '#include "flash_common.cuh"' in (csrc / f"{kernel}.cu").read_text()
    common = (csrc / "flash_common.cuh").read_text()
    plain = inspect.getsource(hash_dropout)
    for const in ("2654435761", "0x9E3779B9", "40503", "51329"):
        assert const in common and const in plain, const
    assert "hash_avalanche(" in common          # the shared avalanche, not a copy


def test_infer_cli_raises_without_cuda(monkeypatch, tmp_path):
    """The scoring entry point runs on the card unless --device cpu: with no
    card it raises before it loads anything."""
    from mmda_tpu_torch.cli import infer as cli_infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_infer.main(["--data", "synthetic", "--use_bert", "False",
                        "--ckpt_dir", str(tmp_path)])


def test_train_cli_raises_without_cuda(monkeypatch):
    """The training entry point runs on the card unless --device cpu: with
    no card it raises before any training."""
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli_train, "load_data", lambda cfg: ({"train": {}}, None))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(use_bert=False), {"train": {}})
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--data", "synthetic", "--use_bert", "False"])
