"""Checkpoints in the JAX package's format: the best-on-dev export and the
`last_*` train-state snapshots that resume a run.

`mmda_tpu/train/checkpoint.py::save_checkpoint` writes
`{ckpt_dir}/{name}.msgpack` in the fastser codec (`mmda_tpu/train/
fastser.py`), with the run's metadata beside it in `{name}.json`:

    MMDAFSR1 | header length (8 bytes, little-endian) | JSON header | leaf bytes

The header lists every leaf with its '/'-joined path and either an inline
value or {dtype, shape, offset, nbytes} into the leaf bytes.  This module
parses and writes it with json and numpy alone; bfloat16 leaves travel as
their 16 bits.  Legacy flax-msgpack payloads are refused.

`save_checkpoint` writes a model's parameters as the JAX parameter tree
(`convert.to_jax_tree`), so the JAX package's `load_checkpoint` and the
port's `Predictor` both load what the port's trainer saves.

A train-state snapshot (`TrainState`: the step, the model, the optimizer,
the generator, the EMA shadow) is written whole by `save_train_state`, or by
`save_checkpoint_incremental` as a content-addressed
`frozen_base_{digest}.msgpack` of the frozen parameters, written once, and a
delta `{name}.inc.msgpack` + `{name}.inc.json` (metadata keys `incremental`,
`base_digest`, `has_ema`) of the rest, as the JAX package names them.  The
parameters use the JAX package's layout: the full snapshot's `params` and
`ema_params` are the JAX tree, the base and the delta's `trainable` /
`ema_trainable` map `jax.tree_util.keystr` paths ("['bert']['layers'][0]
['attn_ln']['bias']") to leaves, so the JAX package reads a port snapshot's
parameters and the same frozen parameters give the same base digest in
both packages.  The rest is the port's own layout, since optax's nested
state and a JAX PRNG key have no counterpart here:

    step                 int, training mini-steps taken
    opt_state/count      int, updates applied
    opt_state/lr         float, the plateau schedule's rate
    opt_state/mini_step  int, mini-steps folded into the accumulators
    opt_state/{mu,nu,acc}/<port parameter name>   the optimizer's tensors
    generator            uint8, `torch.Generator.get_state()`

so a JAX `last_*` snapshot does not resume in the port, nor a port one in
JAX.  Under tensor parallelism every file holds the full layout, as the JAX
package's msgpack backend writes sharded arrays: `full_layout` gathers a
train state's blocks over 'model' (every rank of the row takes part), the
chief writes it, and a resume at any tp takes each rank's blocks of it
(`mesh=`).  Writes go to a unique temporary file in the same directory and are
renamed into place; each path has a lock and a sequence number, so a stale
asynchronous write never replaces a newer one.  An asynchronous save copies
every tensor to the host before it returns: later steps cannot change what
its thread writes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mmda_tpu_torch.convert import convert_params, jax_leaves, to_jax_tree
from mmda_tpu_torch.parallel import mesh as pmesh

MAGIC = b"MMDAFSR1"
_INLINE = (bool, int, float, str, type(None))
FROZEN_BASE_FMT = "frozen_base_{digest}.msgpack"


def _leaf(data: bytearray, base: int, ent: Dict) -> torch.Tensor:
    name = ent["dtype"]
    off = base + ent["offset"]
    if name == "bfloat16":
        arr = np.frombuffer(data, np.uint16, ent["nbytes"] // 2, off)
        return torch.from_numpy(arr.reshape(ent["shape"])).view(torch.bfloat16)
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"leaf {ent['path']!r} has dtype {name!r}, which the "
                         "port cannot read") from None
    arr = np.frombuffer(data, dt, ent["nbytes"] // dt.itemsize, off)
    return torch.from_numpy(arr.reshape(ent["shape"]))


def from_bytes(data: bytes) -> Dict[str, Any]:
    """Nested dict of tensors / inline values from a fastser payload."""
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError(
            "not a fastser checkpoint (no MMDAFSR1 magic): legacy flax-msgpack "
            "checkpoints cannot be read by the port; re-save it with the JAX "
            "package's default codec")
    buf = bytearray(data)          # writable, so tensors view it without a copy
    n = int.from_bytes(buf[8:16], "little")
    header = json.loads(bytes(buf[16:16 + n]).decode())
    base = 16 + n
    nested: Dict[str, Any] = {}
    for ent in header:
        if ent.get("empty_dict"):
            leaf: Any = {}
        elif "dtype" in ent:
            leaf = _leaf(buf, base, ent)
        else:
            leaf = ent.get("value")
        parts = ent["path"].strip("/").split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return nested


def load_checkpoint(ckpt_dir: str, name: str) -> Dict[str, Any]:
    """The parameter tree saved as {ckpt_dir}/{name}.msgpack."""
    with open(os.path.join(ckpt_dir, f"{name}.msgpack"), "rb") as f:
        return from_bytes(f.read())


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f"{name}.msgpack"))


def _leaves(tree: Dict[str, Any], prefix: str, out: List) -> None:
    """(path, leaf) in fastser order: keys sorted at every level."""
    if not tree and prefix:
        out.append((prefix, tree))            # an empty dict round-trips as such
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _leaves(tree[k], f"{prefix}/{k}", out)
        else:
            out.append((f"{prefix}/{k}", tree[k]))


def _array(leaf: Any) -> Tuple[np.ndarray, str]:
    """The C-contiguous host array of a tensor leaf, and its dtype's name."""
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def to_chunks(tree: Dict[str, Any]) -> List[Any]:
    """[header, leaf bytes, ...] of a nested dict of tensors and inline
    values (bool, int, float, str, None)."""
    leaves: List = []
    _leaves(tree, "", leaves)
    header, buffers, offset = [], [], 0
    for path, leaf in leaves:
        if isinstance(leaf, dict):
            header.append({"path": path, "empty_dict": True})
            continue
        if isinstance(leaf, _INLINE):
            header.append({"path": path, "value": leaf})
            continue
        arr, dtype = _array(leaf)
        header.append({"path": path, "dtype": dtype, "shape": list(arr.shape),
                       "offset": offset, "nbytes": arr.nbytes})
        buffers.append(arr.data if arr.nbytes else b"")
        offset += arr.nbytes
    hdr = json.dumps(header).encode()
    return [MAGIC + len(hdr).to_bytes(8, "little") + hdr, *buffers]


def _atomic_write(path: str, chunks: List[Any]) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


# One lock per path, so two saves of one name never interleave, and a
# sequence number per path, so a write that wins the lock after a newer
# snapshot landed is dropped instead of replacing it.
_write_locks: Dict[str, threading.Lock] = {}
_issued_seq: Dict[str, int] = {}
_committed_seq: Dict[str, int] = {}
_guard = threading.Lock()


def _next_seq(path: str) -> int:
    with _guard:
        _issued_seq[path] = _issued_seq.get(path, 0) + 1
        return _issued_seq[path]


def _write(path: str, seq: int, chunks: List[Any], meta_path: str, meta: Dict,
           before=None) -> None:
    """Write `chunks` to `path` and `meta` to `meta_path` unless a newer
    write of `path` already landed; `before` (path, chunks) first."""
    if before is not None:
        _atomic_write(*before)
    with _guard:
        lock = _write_locks.setdefault(path, threading.Lock())
    with lock:
        if _committed_seq.get(path, 0) > seq:
            return
        _committed_seq[path] = seq
        _atomic_write(path, chunks)
        _atomic_write(meta_path, [json.dumps(meta, indent=2, default=str).encode()])


def _dispatch(ckpt_dir: str, file: str, chunks: List[Any], meta_file: str, meta: Dict,
              async_write: bool, before=None) -> Optional[threading.Thread]:
    """Write now, or on a thread that the caller joins (returned)."""
    path = os.path.join(ckpt_dir, file)
    args = (path, _next_seq(path), chunks, os.path.join(ckpt_dir, meta_file), meta, before)
    if not async_write:
        _write(*args)
        return None
    thread = threading.Thread(target=_write, args=args, daemon=True)
    thread.start()
    return thread


def save_checkpoint(ckpt_dir: str, name: str, model: nn.Module,
                    metadata: Optional[Dict] = None,
                    async_write: bool = False,
                    tensors: Optional[List[torch.Tensor]] = None) -> Optional[threading.Thread]:
    """Write `model`'s parameters (or `tensors` in their place, in
    `named_parameters` order: the full layout of a sharded model) as
    {ckpt_dir}/{name}.msgpack (the JAX tree layout) and `metadata` as
    {name}.json.  With async_write the parameters are copied to the host
    now and the files written on a thread, which is returned for the
    caller to join."""
    os.makedirs(ckpt_dir, exist_ok=True)
    return _dispatch(ckpt_dir, f"{name}.msgpack", to_chunks(to_jax_tree(model, tensors)),
                     f"{name}.json", dict(metadata or {}), async_write)


# ------------------------------------------------------ train-state snapshots


class TrainState(NamedTuple):
    """What a `last_*` snapshot holds and a resume restores, in place.
    `params`: the model's parameters in the full layout where the model
    holds blocks of them (`full_layout`), None to read the model's own."""
    step: int
    model: nn.Module
    optimizer: Any                       # train/state.py::Optimizer
    generator: torch.Generator
    ema: Optional[List[torch.Tensor]] = None   # shadow of model.parameters()
    params: Optional[List[torch.Tensor]] = None


class _Gathered(NamedTuple):
    """An optimizer's parameters beside its state in the full layout."""
    params: List[torch.Tensor]
    state: Dict[str, Any]

    def state_dict(self) -> Dict[str, Any]:
        return self.state


def full_layout(state: TrainState, mesh: "pmesh.Mesh") -> TrainState:
    """`state` with its parameters, its EMA shadow and its optimizer's
    tensors gathered whole over the mesh's 'model' row (a collective: every
    rank of the row calls it), for a snapshot of a tensor-parallel run; the
    model and the generator are `state`'s."""
    if mesh.tp == 1:
        return state
    model, opt = state.model, state.optimizer
    specs = pmesh.param_partition_specs(model, mesh.tp)
    names = {id(p): n for n, p in model.named_parameters()}
    dims = [specs.get(names[id(p)]) for p in opt.params]
    held = dict(opt.state_dict())
    keys = [k for k in ("mu", "nu", "acc") if held[k]]
    whole = pmesh.gather_tensors([t for k in keys for t in held[k]], dims * len(keys), mesh)
    for j, k in enumerate(keys):
        held[k] = whole[j * len(dims):(j + 1) * len(dims)]
    return state._replace(
        optimizer=_Gathered(opt.params, held), params=pmesh.gather_params(model, mesh),
        ema=pmesh.gather_params(model, mesh, state.ema) if state.ema else None)


def keystr(path: str) -> str:
    """`jax.tree_util.keystr` of a dotted JAX parameter path: a digit part
    is a list index (the BERT layers), any other a dict key."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path.split("."))


def _dotted(key: str) -> str:
    """The inverse of `keystr`."""
    return ".".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", key))


def _opt_tree(state: TrainState) -> Dict[str, Any]:
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    keys = [names[id(p)] for p in opt.params]
    sd = opt.state_dict()
    tree: Dict[str, Any] = {"count": sd["count"], "lr": float(sd["lr"]),
                            "mini_step": sd["mini_step"]}
    for k in ("mu", "nu", "acc"):
        tree[k] = {n: t.detach().to("cpu", copy=True) for n, t in zip(keys, sd[k])}
    return tree


def save_train_state(ckpt_dir: str, name: str, state: TrainState,
                     metadata: Optional[Dict] = None,
                     async_write: bool = False) -> Optional[threading.Thread]:
    """The whole train state as {ckpt_dir}/{name}.msgpack (+ .json).  With
    async_write the tensors are copied to the host now and the file written
    on a thread, which is returned for the caller to join."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = {"step": int(state.step), "params": to_jax_tree(state.model, state.params),
            "opt_state": _opt_tree(state), "generator": state.generator.get_state(),
            "ema_params": to_jax_tree(state.model, state.ema) if state.ema else None}
    return _dispatch(ckpt_dir, f"{name}.msgpack", to_chunks(tree), f"{name}.json",
                     dict(metadata or {}), async_write)


# A run's frozen parameters never change, so the base's digest is computed
# once per (ckpt_dir, name) in a process.
_base_digest_cache: Dict[str, str] = {}


def save_checkpoint_incremental(ckpt_dir: str, name: str, state: TrainState,
                                metadata: Optional[Dict] = None,
                                async_write: bool = False) -> Optional[threading.Thread]:
    """The train state as the frozen parameters' base (written once, named
    by the sha256 of its bytes) and a delta of everything else at
    {name}.inc.msgpack (+ .inc.json); the base lands before the delta."""
    os.makedirs(ckpt_dir, exist_ok=True)
    frozen = [not p.requires_grad for p in state.model.parameters()]

    def split(leaves, want_frozen):
        return {keystr(path): v for (path, v), f in zip(leaves, frozen) if f == want_frozen}

    leaves = jax_leaves(state.model, state.params)
    trainable, frozen_leaves = split(leaves, False), split(leaves, True)
    cache_key = os.path.join(ckpt_dir, name)
    digest = _base_digest_cache.get(cache_key)
    base = None
    if digest is None and frozen_leaves:
        chunks = to_chunks(frozen_leaves)
        h = hashlib.sha256()
        for chunk in chunks:
            h.update(chunk)
        digest = h.hexdigest()[:16]
        path = os.path.join(ckpt_dir, FROZEN_BASE_FMT.format(digest=digest))
        if not os.path.exists(path):
            base = (path, chunks)
        _base_digest_cache[cache_key] = digest
    delta: Dict[str, Any] = {"trainable": trainable, "opt_state": _opt_tree(state),
                             "step": int(state.step), "generator": state.generator.get_state()}
    if state.ema:
        delta["ema_trainable"] = split(jax_leaves(state.model, state.ema), False)
    meta = dict(metadata or {}, incremental=True, base_digest=digest,
                has_ema=bool(state.ema))
    return _dispatch(ckpt_dir, f"{name}.inc.msgpack", to_chunks(delta),
                     f"{name}.inc.json", meta, async_write, before=base)


def incremental_checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f"{name}.inc.msgpack"))


@torch.no_grad()
def _restore(state: TrainState, params: Dict[str, Any], opt: Dict[str, Any],
             generator: torch.Tensor, ema: Optional[Dict[str, Any]],
             mesh: Optional["pmesh.Mesh"] = None) -> None:
    """Copy a snapshot's pieces (the full layout) into `state`'s own
    tensors: under a tensor-parallel `mesh`, this rank's blocks of them."""
    model = state.model
    local = pmesh.local_blocks(model, mesh)
    model.load_state_dict(convert_params(params, model, local), strict=True)  # copy_ in place
    if ema is not None:
        if not state.ema:
            raise ValueError("the snapshot holds an EMA shadow; this run keeps none")
        values = convert_params(ema, model, local)
        for (n, _), t in zip(model.named_parameters(), state.ema):
            t.copy_(values[n])
    elif state.ema:
        raise ValueError("this run keeps an EMA shadow; the snapshot holds none")
    by_name = {n: p for n, p in model.named_parameters()}
    names = {id(p): n for n, p in by_name.items()}
    keys = [names[id(p)] for p in state.optimizer.params]
    loaded = {"count": opt["count"], "lr": opt["lr"], "mini_step": opt["mini_step"]}
    for k in ("mu", "nu", "acc"):
        held = opt.get(k) or {}
        if set(held) != set(keys) and (held or getattr(state.optimizer, k)):
            raise ValueError(f"optimizer state {k!r} holds {sorted(held)[:3]}..., "
                             f"this run trains {sorted(keys)[:3]}...")
        loaded[k] = ([held[n] if local is None else local(n, held[n]) for n in keys]
                     if held else [])
    state.optimizer.load_state_dict(loaded)
    state.generator.set_state(generator.contiguous())


def _read(ckpt_dir: str, file: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, file), "rb") as f:
        return from_bytes(f.read())


def load_train_state(ckpt_dir: str, name: str, state: TrainState,
                     mesh: Optional["pmesh.Mesh"] = None) -> int:
    """Restore {ckpt_dir}/{name}.msgpack into `state` in place (this rank's
    blocks under a tensor-parallel `mesh`); returns the snapshot's step."""
    tree = _read(ckpt_dir, f"{name}.msgpack")
    _restore(state, tree["params"], tree["opt_state"], tree["generator"],
             tree.get("ema_params"), mesh)
    return int(tree["step"])


def load_checkpoint_incremental(ckpt_dir: str, name: str, state: TrainState,
                                mesh: Optional["pmesh.Mesh"] = None) -> int:
    """Restore a snapshot of `save_checkpoint_incremental` into `state` in
    place (the frozen parameters from the base its metadata names; this
    rank's blocks under a tensor-parallel `mesh`); returns its step."""
    with open(os.path.join(ckpt_dir, f"{name}.inc.json")) as f:
        meta = json.load(f)
    delta = _read(ckpt_dir, f"{name}.inc.msgpack")
    base: Dict[str, Any] = {}
    if meta.get("base_digest"):
        base = _read(ckpt_dir, FROZEN_BASE_FMT.format(digest=meta["base_digest"]))

    def flat(leaves: Dict[str, Any]) -> Dict[str, Any]:
        return {_dotted(k): v for k, v in {**leaves, **base}.items()}

    ema = flat(delta["ema_trainable"]) if meta.get("has_ema") else None
    _restore(state, flat(delta["trainable"]), delta["opt_state"], delta["generator"], ema,
             mesh)
    return int(delta["step"])


def best_model_name(cfg) -> str:
    """Best-on-dev export name: best_model_{model}[_C]_{data}."""
    suffix = "_C" if cfg.use_confidNet else ""
    return f"best_model_{cfg.model}{suffix}_{cfg.data}"
