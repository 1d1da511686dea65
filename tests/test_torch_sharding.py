"""The port's sharding rules (``repro_torch.sharding``, ``launch.mesh``)
and ``compressed_psum`` against the reference's.

- ``param_pspecs`` for all ten ``ARCHS`` at full size (the reference's
  ``prod_config(arch, "train_4k")``), on the single (16, 16) and the
  multi-pod (2, 16, 16) production mesh (shape-only meshes): leaf for
  leaf equal to the reference's ``rules.param_pspecs`` over
  ``jax.eval_shape(init_params)``, with the reference's leading stacking
  axis dropped for the layers of a group (the port keeps a tensor a layer,
  shapes from ``LM(cfg, "meta")``); the same for the AdamW state with
  8-bit moments (``{"q", "s"}`` under each name); ``unknown_leaves`` empty.
- ``activation_specs`` (with and without ``seq_shard_attn``),
  ``cache_pspecs`` of every eligible decode shape (the mesh roles the
  reference's test uses) and ``batch_pspecs``: equal to the reference's.
- ``placements``: a spec on a mesh as DTensor placements (a tuple entry
  split major to minor; out-of-order or repeated axes refused);
  ``make_production_mesh`` / ``make_mesh_info``; ``make_host_mesh``'s
  divisibility assertion without a process group.
- ``compressed_psum`` on 2 gloo ranks: bit for bit the sum of the
  reference's ``dequantize_int8(quantize_int8(x_r))`` over the ranks'
  inputs (a block size that does not divide the input, and the default);
  and the reference test's one-device case (``linspace(-1, 1, 256)``
  over an axis of one rank, within 1e-2 of x), equal to the reference's
  ``shard_map`` call bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import ARCHS, SHAPES, eligible_shapes
from repro.launch.dryrun import prod_config
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.sharding import rules as jrules
from repro.sharding.partition import MeshInfo as JMeshInfo
from repro.train import optimizer as jopt
from repro_torch.launch import mesh as tmesh
from repro_torch.models.config import LMConfig
from repro_torch.models.model import GROUP_KEYS, LM
from repro_torch.sharding import partition as tpart
from repro_torch.sharding import rules as trules
from repro_torch.train import optimizer as topt
from torch.distributed.tensor import Replicate, Shard

from _torch_dist import psum_rank, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def port_cfg(cfg) -> LMConfig:
    return LMConfig(**dataclasses.asdict(cfg))


def mesh_infos(kind: str):
    jm = tmesh.ShapeMesh(MESHES[kind])
    dp = tuple(a for a in jm.axis_names if a in ("pod", "data"))
    return (JMeshInfo(mesh=jm, dp=dp, tp="model"),
            tpart.MeshInfo(mesh=jm, dp=dp, tp="model"))


@functools.lru_cache(maxsize=None)
def full(arch: str):
    """(reference config, reference parameter shapes, port config, port
    model on the meta device)."""
    cfg, _ = prod_config(arch, "train_4k")
    shapes = jax.eval_shape(functools.partial(j_init_params, cfg),
                            jax.random.PRNGKey(0))
    tcfg = port_cfg(cfg)
    return cfg, shapes, tcfg, LM(tcfg, "meta")


def unstacked(tree, stacked: bool = False, prefix: str = "") -> dict:
    """A reference spec tree as the port's names: each group's leaves,
    stacked on a leading axis, one entry a layer without that axis's
    ``None`` (8-bit states keep their ``q``/``s`` keys)."""
    out = {}
    for key, val in tree.items():
        if key in GROUP_KEYS and not prefix:
            for g, group in enumerate(val):
                out.update(unstacked(group, True, f"{key}.{g}.*."))
        elif isinstance(val, dict):
            sub = unstacked(val, stacked, "")
            for k, s in sub.items():
                out[f"{prefix}{key}.{k}"] = s
        else:
            spec = tuple(val)
            if stacked:
                assert spec[0] is None
                spec = spec[1:]
            out[f"{prefix}{key}"] = spec
    return out


def flat_port(tree, prefix: str = "") -> dict:
    """The port's spec tree flattened to dotted names, each group layer's
    index replaced by ``*`` (the reference's one stacked leaf)."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat_port(val, name + "."))
        else:
            parts = name.split(".")
            if parts[0] in GROUP_KEYS:
                parts[2] = "*"
            elif len(parts) > 1 and parts[1] in GROUP_KEYS:
                parts[3] = "*"
            out[".".join(parts)] = tuple(val)
    return out


def _norm(spec) -> tuple:
    """A spec's entries with 1-tuples of axis names as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def assert_same_specs(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    for name, spec in port.items():
        assert _norm(spec) == _norm(ref[name]), (name, spec, ref[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_param_pspecs_match_reference(arch, mesh_kind):
    cfg, shapes, tcfg, model = full(arch)
    jmi, tmi = mesh_infos(mesh_kind)
    params = dict(model.named_parameters())
    port = trules.param_pspecs(tcfg, params, tmi)
    assert all(isinstance(s, tpart.P) for s in port.values())
    assert_same_specs(flat_port(port),
                      unstacked(jrules.param_pspecs(cfg, shapes, jmi)))
    assert trules.unknown_leaves(tcfg, params, tmi) == []
    assert jrules.unknown_leaves(cfg, shapes, jmi) == []


@pytest.mark.parametrize("arch", ["grok-1-314b", "falcon-mamba-7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_opt_state_pspecs_match_reference(arch):
    """The AdamW state with 8-bit moments: q codes keep the parameter's
    spec, row scales drop its last entry; the step count replicated."""
    cfg, shapes, tcfg, model = full(arch)
    jmi, tmi = mesh_infos("multi")
    jcfg = jopt.OptConfig(state_int8=True)
    jstate = jax.eval_shape(lambda p: jopt.adamw_init(jcfg, p), shapes)
    tstate = topt.adamw_init(topt.OptConfig(state_int8=True),
                             dict(model.named_parameters()))
    port = trules.param_pspecs(tcfg, tstate, tmi)
    ref = jrules.param_pspecs(cfg, jstate, jmi)
    assert tuple(port["step"]) == () and tuple(ref["step"]) == ()
    for key in ("m", "v"):
        assert_same_specs(flat_port(port[key]), unstacked(ref[key]))
    assert any(isinstance(v, dict) for v in tstate["m"].values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_activation_specs_match_reference(arch, mesh_kind):
    cfg, _, tcfg, _ = full(arch)
    jmi, tmi = mesh_infos(mesh_kind)
    for kw in ({}, {"seq_shard_attn": True}, {"cache_len": 32768}):
        port = trules.activation_specs(tcfg, tmi, **kw)
        ref = jrules.activation_specs(cfg, jmi, **kw)
        assert_same_specs(port, {k: tuple(v) for k, v in ref.items()})
    ctx = trules.make_ctx(tcfg, tmi)
    assert ctx.mi is tmi and ctx.act_specs == trules.activation_specs(tcfg,
                                                                      tmi)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspecs_match_reference(arch):
    """Every eligible decode shape at full size, with the reference test's
    mesh roles (B == 1: the data axis joins the model axis)."""
    n = 0
    for shape in eligible_shapes(arch):
        sh = SHAPES[shape]
        if sh.kind != "decode":
            continue
        cfg, _ = prod_config(arch, shape)
        tcfg = port_cfg(cfg)
        jm = tmesh.ShapeMesh(MESHES["single"])
        dp = ("data",) if sh.global_batch > 1 else ()
        tp = "model" if sh.global_batch > 1 else ("data", "model")
        jmi = JMeshInfo(mesh=jm, dp=dp, tp=tp)
        tmi = tpart.MeshInfo(mesh=jm, dp=dp, tp=tp)
        mem_len = sh.seq_len if cfg.family == "encdec" else 0
        jcache = jax.eval_shape(lambda: j_init_cache(
            cfg, sh.global_batch, sh.seq_len, mem_len=mem_len))
        tcache = LM(tcfg, "meta").init_cache(sh.global_batch, sh.seq_len,
                                             mem_len)
        ref = jrules.cache_pspecs(cfg, jcache, jmi, cache_len=sh.seq_len)
        port = trules.cache_pspecs(tcfg, tcache, tmi, cache_len=sh.seq_len)
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_same_specs(flat_port(p), {
                k: tuple(v) for k, v in flat_port_ref(r).items()})
            n += 1
    assert n > 0


def flat_port_ref(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat_port_ref(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def test_batch_pspecs_match_reference():
    jmi, tmi = mesh_infos("multi")
    jb = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
          "src_embeds": jax.ShapeDtypeStruct((256, 300, 1024), jnp.float32)}
    tb = {k: np.zeros(v.shape, np.int8) for k, v in jb.items()}
    ref = jrules.batch_pspecs(jb, jmi)
    port = trules.batch_pspecs(tb, tmi)
    assert port == {k: tuple(v) for k, v in ref.items()}
    assert tuple(port["tokens"])[0] == ("pod", "data")


def test_spec_to_placements():
    multi = tmesh.make_production_mesh(multi_pod=True)
    single = tmesh.make_production_mesh()
    assert multi.shape == MESHES["multi"] and multi.size == 512
    assert single.axis_names == ("data", "model")
    P = tpart.P
    assert tpart.placements(multi, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tpart.placements(single, P(None, "model")) == (
        Replicate(), Shard(1))
    assert tpart.placements(single, P()) == (Replicate(), Replicate())
    with pytest.raises(ValueError):     # minor axis first
        tpart.placements(multi, P(("data", "pod")))
    with pytest.raises(ValueError):     # one axis on two dims
        tpart.placements(single, P("model", "model"))
    mi = tmesh.make_mesh_info(multi)
    assert (mi.dp, mi.tp, mi.dp_size, mi.tp_size) == (
        ("pod", "data"), "model", 32, 16)
    assert mi.fsdp == ("pod", "data")
    assert tpart.MeshInfo(mesh=single, dp=("data",)).fsdp == ("data",)
    assert tpart.MeshInfo(mesh=multi, dp=("pod", "data"),
                          fsdp_over=("data",)).fsdp == ("data",)
    assert mi.named(P("model")) == (multi, (Replicate(), Replicate(),
                                            Shard(0)))


def test_host_mesh_needs_divisible_ranks():
    """One process (no group) and two model ranks: the reference's
    assertion."""
    with pytest.raises(AssertionError):
        tmesh.make_host_mesh(2)


def test_shard_is_a_no_op_without_dtensors():
    import torch
    x = torch.ones(2, 3)
    assert tpart.shard(x, "act") is x
    _, tmi = mesh_infos("single")
    with tpart.use_sharding(trules.make_ctx(port_cfg(full("smollm-360m")[0]),
                                            tmi)):
        assert tpart.current_ctx() is not None
        assert tpart.shard(x, "act") is x
    assert tpart.current_ctx() is None


# ---------------------------------------------------------------------------
# compressed_psum on 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((37, 100)) * s).astype(np.float32)
          for s in (1.0, 3e-3)]
    blocks = (256, 64)
    lin = np.asarray(jnp.linspace(-1, 1, 256))
    return xs, blocks, run_ranks(psum_rank, 2, tmp_path_factory.mktemp(
        "psum"), xs, blocks, lin)


def _ref_deq(x, block=256):
    q, s = jopt.quantize_int8(jnp.asarray(x), block)
    return np.asarray(jopt.dequantize_int8(q, s, x.shape, block))


def test_compressed_psum_matches_reference_on_two_ranks(psum_runs):
    xs, blocks, outs = psum_runs
    for b in blocks:
        want = _ref_deq(xs[0], b) + _ref_deq(xs[1], b)
        for out in outs:
            np.testing.assert_array_equal(out[b], want)
    for out in outs:
        np.testing.assert_array_equal(out["ctx"], out[256])


def test_compressed_psum_one_device_case(psum_runs):
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    x = jnp.linspace(-1, 1, 256)
    y = jax.jit(jax.shard_map(lambda x: jopt.compressed_psum(x, "d"), mesh=mesh,
                          in_specs=PartitionSpec(None),
                          out_specs=PartitionSpec(None)))(x)
    for out in psum_runs[2]:
        np.testing.assert_allclose(out["one"], np.asarray(x), atol=1e-2)
        np.testing.assert_array_equal(out["one"], np.asarray(y))


def test_compressed_psum_needs_a_mesh():
    import torch
    with pytest.raises(ValueError):
        topt.compressed_psum(torch.ones(4), "d")
