"""Carry scenes, cameras, projections and training state across from
the JAX package.

Each *_from_numpy function takes the fields of a JAX-side object as
numpy arrays — what `jax.device_get` returns, as an object with those
attributes or as a mapping — and builds the port's object on `device`.
`to_numpy` goes the other way, for any of the port's objects. The parity
tests build their inputs on the JAX side and hand them over through
these, and compare the results through `to_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.project import Projected
from robosimgs_tpu_torch.train.densify import DensifyState
from robosimgs_tpu_torch.train.optim import FLOAT_FIELDS, AdamGroup, OptState
from robosimgs_tpu_torch.train.trainer import TrainState


def _get(d, name):
    return d[name] if isinstance(d, Mapping) else getattr(d, name)


def _tensor(x, device) -> torch.Tensor:
    # np.array copies: device_get may hand back read-only buffers
    return torch.from_numpy(np.array(x)).to(device)


def gaussians_from_numpy(d, device) -> Gaussians:
    return Gaussians(**{f.name: _tensor(_get(d, f.name), device)
                        for f in dataclasses.fields(Gaussians)})


def camera_from_numpy(d, device) -> Camera:
    return Camera(
        **{k: _tensor(np.asarray(_get(d, k), np.float32), device)
           for k in ("fx", "fy", "cx", "cy", "c2w")},
        width=int(_get(d, "width")), height=int(_get(d, "height")))


def projected_from_numpy(d, device) -> Projected:
    fields = {}
    for f in dataclasses.fields(Projected):
        v = _get(d, f.name)
        fields[f.name] = None if v is None else _tensor(v, device)
    return Projected(**fields)


def densify_state_from_numpy(d, device) -> DensifyState:
    return DensifyState(**{f.name: _tensor(_get(d, f.name), device)
                           for f in dataclasses.fields(DensifyState)})


def opt_state_from_numpy(d, device) -> OptState:
    """The port's per-group Adam state from the JAX package's optax
    state: a MultiTransformState whose inner_states[label].inner_state
    is (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count) for
    the scheduled means lr, or an empty state), mu and nu being dicts
    over every field with the group's own array under its label. The
    "exposure" and "bilagrid" labels come along where the state has
    them."""
    inner = _get(d, "inner_states")
    state = {}
    for label in FLOAT_FIELDS + tuple(k for k in ("exposure", "bilagrid")
                                      if k in inner):
        chain = _get(inner[label], "inner_state")
        adam = chain[0]
        # a NamedTuple's fields: an empty state is a tuple, whose
        # tuple.count method is no field
        sched = (chain[1].count if len(chain) > 1
                 and "count" in getattr(chain[1], "_fields", ()) else None)
        state[label] = AdamGroup(
            mu=_tensor(_get(adam, "mu")[label], device),
            nu=_tensor(_get(adam, "nu")[label], device),
            count=_tensor(np.asarray(_get(adam, "count"), np.int32), device),
            sched_count=None if sched is None
            else _tensor(np.asarray(sched, np.int32), device))
    return state


def train_state_from_numpy(d, device, generator=None) -> TrainState:
    """The JAX package's TrainState (gaussians, optax state, densify
    state, step, exposure and bilateral grids where set). Its PRNG key
    has no torch counterpart: the port's state takes `generator`
    (default: a CPU generator seeded 0)."""
    def optional(name):
        v = d.get(name) if isinstance(d, Mapping) else getattr(d, name, None)
        return None if v is None else _tensor(v, device)

    return TrainState(
        gaussians=gaussians_from_numpy(_get(d, "gaussians"), device),
        opt_state=opt_state_from_numpy(_get(d, "opt_state"), device),
        densify_state=densify_state_from_numpy(_get(d, "densify_state"),
                                               device),
        step=int(_get(d, "step")),
        generator=generator or torch.Generator().manual_seed(0),
        exposure=optional("exposure"), bilagrid=optional("bilagrid"))


def _map_leading(state: TrainState, n: int, fn) -> TrainState:
    """fn applied to every tensor of the state whose leading dim is n
    (the JAX package's _leading_dim_specs rule: parameters, Adam moments,
    densify statistics; and a per-frame tensor whose frame count is n)."""
    def f(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n:
            return fn(x)
        return x

    return dataclasses.replace(
        state,
        gaussians=state.gaussians.replace(**{
            fl.name: f(getattr(state.gaussians, fl.name))
            for fl in dataclasses.fields(state.gaussians)}),
        opt_state={k: dataclasses.replace(s, mu=f(s.mu), nu=f(s.nu))
                   for k, s in state.opt_state.items()},
        densify_state=state.densify_state.map(f),
        exposure=None if state.exposure is None else f(state.exposure),
        bilagrid=None if state.bilagrid is None else f(state.bilagrid))


def shard_train_state(state: TrainState, n_shard: int,
                      data_rank: int) -> TrainState:
    """Shard `data_rank` of n_shard of a whole state: slots
    [r cap/n, (r+1) cap/n) of every capacity-leading tensor, the rest
    whole — the state a rank of the port's gaussian-sharded step
    holds."""
    cap = state.gaussians.capacity
    if cap % n_shard:
        raise ValueError(f"capacity {cap} does not split into {n_shard}")
    local = cap // n_shard
    sl = slice(data_rank * local, (data_rank + 1) * local)
    return _map_leading(state, cap, lambda x: x[sl].clone())


def shard_train_state_from_numpy(d, n_shard: int, data_rank: int, device,
                                 generator=None) -> TrainState:
    """shard_train_state of a JAX TrainState's numpy tree (as
    train_state_from_numpy takes it)."""
    return shard_train_state(train_state_from_numpy(d, device, generator),
                             n_shard, data_rank)


def gather_train_state(state: TrainState, mesh) -> TrainState:
    """The whole state from every shard's (the inverse of the sharding):
    each capacity-leading tensor all-gathered over 'data' in shard order.
    Every rank of the mesh calls it."""
    from robosimgs_tpu_torch.parallel import comm
    group = mesh.get_group("data")

    def gather(x):
        if x.dtype == torch.bool:
            return comm.all_gather(x.to(torch.uint8), group).to(torch.bool)
        return comm.all_gather(x, group)

    return _map_leading(state, state.gaussians.capacity, gather)


def _dense(tree, prefix) -> dict:
    """A flax Dense (kernel (in, out), bias) as nn.Linear's (out, in)."""
    return {f"{prefix}.weight": torch.from_numpy(np.array(tree["kernel"]).T),
            f"{prefix}.bias": torch.from_numpy(np.array(tree["bias"]))}


def policy_params_from_numpy(tree) -> dict:
    """The port's DiffusionPolicy state dict (CPU tensors) from the JAX
    package's flax parameters as numpy arrays ({"params": ...} or its
    inner dict). The names follow nn.compact order: encoder Conv_0..3,
    Dense_0 (state), Dense_1 (head), ss_log_temp; denoiser Dense_0 (t),
    Dense_1 (cond), Dense_2 (in), FiLMBlock_i {Dense_0 h, Dense_1 scale,
    Dense_2 shift, LayerNorm_0, Dense_3}, Dense_3 (out). Dense kernels go
    (in, out) -> (out, in), conv kernels HWIO -> OIHW."""
    p = tree.get("params", tree)
    enc, den = p["encoder"], p["denoiser"]
    sd = {}
    i = 0
    while f"Conv_{i}" in enc:
        conv = enc[f"Conv_{i}"]
        sd[f"encoder.convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.array(conv["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"encoder.convs.{i}.bias"] = torch.from_numpy(np.array(conv["bias"]))
        i += 1
    if "ss_log_temp" in enc:
        sd["encoder.ss_log_temp"] = torch.from_numpy(np.array(enc["ss_log_temp"]))
    sd.update(_dense(enc["Dense_0"], "encoder.state"))
    sd.update(_dense(enc["Dense_1"], "encoder.head"))
    for name, mod in (("Dense_0", "t_proj"), ("Dense_1", "cond"),
                      ("Dense_2", "inp"), ("Dense_3", "out")):
        sd.update(_dense(den[name], f"denoiser.{mod}"))
    i = 0
    while f"FiLMBlock_{i}" in den:
        blk, pre = den[f"FiLMBlock_{i}"], f"denoiser.blocks.{i}"
        for name, mod in (("Dense_0", "h"), ("Dense_1", "scale"),
                          ("Dense_2", "shift"), ("Dense_3", "out")):
            sd.update(_dense(blk[name], f"{pre}.{mod}"))
        sd[f"{pre}.norm.weight"] = torch.from_numpy(
            np.array(blk["LayerNorm_0"]["scale"]))
        sd[f"{pre}.norm.bias"] = torch.from_numpy(
            np.array(blk["LayerNorm_0"]["bias"]))
        i += 1
    return sd


def masknet_params_from_numpy(tree) -> dict:
    """The port's MaskUNet state dict (CPU tensors) from the JAX package's
    flax parameters as numpy arrays ({"params": ...} or its inner dict).
    Conv_i is convs.i, its kernel HWIO -> OIHW; GroupNorm_i is norms.i,
    scale -> weight."""
    p = tree.get("params", tree)
    sd = {}
    for name, leaves in p.items():
        kind, i = name.split("_")
        if kind == "Conv":
            sd[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.array(leaves["kernel"]).transpose(3, 2, 0, 1)))
            sd[f"convs.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
        elif kind == "GroupNorm":
            sd[f"norms.{i}.weight"] = torch.from_numpy(
                np.array(leaves["scale"]))
            sd[f"norms.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
        else:
            raise ValueError(f"unexpected MaskUNet module {name!r}")
    return sd


def masknet_params_to_numpy(state_dict) -> dict:
    """The inverse of masknet_params_from_numpy: {"params": {Conv_i,
    GroupNorm_i}} of float32 numpy arrays, modules in flax's sorted key
    order."""
    p = {}
    for key, v in state_dict.items():
        group, i, leaf = key.split(".")
        a = v.detach().cpu().numpy().astype(np.float32)
        if group == "convs":
            mod = p.setdefault(f"Conv_{i}", {})
            if leaf == "weight":
                mod["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
            else:
                mod["bias"] = a
        else:
            mod = p.setdefault(f"GroupNorm_{i}", {})
            mod["scale" if leaf == "weight" else "bias"] = a
    return {"params": {k: dict(sorted(p[k].items())) for k in sorted(p)}}


def to_numpy(x):
    """Any of the port's objects as numpy: tensors as arrays, dataclasses
    and dicts as dicts of their converted fields, anything else as is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, Mapping):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
