"""Sharding rules: logical parameter/activation axes -> partition spec.
The port of ``repro.sharding.rules``.

Strategy, per (arch, shape, mesh):

* parameters + optimizer state: FSDP over the data axes (and pod axis on the
  multi-pod mesh) on the d_model-ish dimension; tensor-parallel over `model`
  on heads / d_ff / vocab / experts;
* activations: batch over (pod, data); d_ff and (when divisible) head dims
  over `model`;
* KV caches: kv-heads over `model` when divisible, otherwise the *sequence*
  dimension over `model`;
* MoE experts: expert-parallel over `model` when n_experts % tp == 0
  (moonshot 64e), else tensor-parallel inside each expert (grok 8e).

Leaf names are unique across block types, so the rule table is a flat
name -> trailing-dims spec map.  The port's trees are keyed by parameter
name (``LM.named_parameters()``: ``groups.0.3.moe.we1``); a leaf's rule is
keyed by the name's last component.  The reference stacks a group's layers
on a leading axis and the port keeps one tensor a layer, so a group leaf's
spec here is the reference's without its leading stacking ``None``: the
rank padding gives exactly that.
"""
from __future__ import annotations

from .partition import MeshInfo, P, ShardingCtx


def _rule_table(cfg, mi: MeshInfo) -> dict[str, tuple]:
    fsdp = tuple(mi.fsdp) or None
    tp = mi.tp
    kv_tp = tp if (cfg.n_kv_heads * cfg.hd) % mi.tp_size == 0 else None
    ep = cfg.n_experts > 0 and cfg.n_experts % mi.tp_size == 0
    t = {
        # embeddings / head
        "embed": (tp, fsdp),
        "lm_head": (fsdp, tp),
        "front_w": (None, fsdp),
        # norms
        "norm": (None,), "q_norm": (None,), "k_norm": (None,),
        "final_norm": (None,), "enc_norm": (None,),
        # attention
        "wq": (fsdp, tp), "wk": (fsdp, kv_tp), "wv": (fsdp, kv_tp),
        "wo": (tp, fsdp),
        "bq": (tp,), "bk": (kv_tp,), "bv": (kv_tp,),
        # dense mlp
        "w1": (fsdp, tp), "w3": (fsdp, tp), "w2": (tp, fsdp),
        # router + experts
        "router": (fsdp, None),
        "we1": (tp, fsdp, None) if ep else (None, fsdp, tp),
        "we3": (tp, fsdp, None) if ep else (None, fsdp, tp),
        "we2": (tp, None, fsdp) if ep else (None, tp, fsdp),
        # mamba
        "in_proj": (fsdp, tp), "out_proj": (tp, fsdp),
        "conv_w": (None, tp), "conv_b": (tp,),
        "x_proj": (tp, None), "dt_w": (None, tp), "dt_b": (tp,),
        "A_log": (tp, None), "Dskip": (tp,),
        # rg-lru (griffin)
        "rg_in": (fsdp, tp), "rg_gate": (fsdp, tp), "rg_out": (tp, fsdp),
        "rg_conv_w": (None, tp), "rg_conv_b": (tp,),
        "rg_a": (None, tp), "rg_i": (None, tp), "rg_lambda": (tp,),
    }
    return t


def _leaves(tree, keys: tuple = ()):
    """(names, leaf) pairs of a nested dict: ``names`` the dotted
    components of every key on the path (``("m", "groups", "0", "3",
    "attn", "wq")``)."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, keys + tuple(str(key).split(".")))
    else:
        yield keys, tree


def _map(fn, tree, keys: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, keys + tuple(str(k).split(".")))
                for k, v in tree.items()}
    return fn(keys, tree)


def param_pspecs(cfg, params, mi: MeshInfo):
    """Partition specs of ``params`` (a dict of tensors keyed by parameter
    name, or an AdamW state of such dicts; anything with a ``shape``).

    A leaf's rule comes from its name; extra leading dims are replicated.
    Unknown leaves are replicated (and listed for review via
    ``unknown_leaves``)."""
    table = _rule_table(cfg, mi)

    def spec_of(names, leaf):
        name = names[-1] if names else None
        q8 = None
        if name in ("q", "s") and len(names) >= 2:   # 8-bit Adam state
            q8, name = name, names[-2]
        rule = table.get(name)
        ndim = len(leaf.shape)
        if rule is None or ndim == 0:
            return P()
        rule = tuple(rule)
        if q8 == "s":               # row scales: drop the last (quantized) dim
            rule = rule[:-1]
        if len(rule) > ndim:        # e.g. bias tables on unstacked use
            rule = rule[-ndim:]
        pad = ndim - len(rule)
        return P(*((None,) * pad + rule))

    return _map(spec_of, params)


def unknown_leaves(cfg, params, mi: MeshInfo) -> list[str]:
    table = _rule_table(cfg, mi)
    return [".".join(names) for names, _ in _leaves(params)
            if not names or names[-1] not in table]


def activation_specs(cfg, mi: MeshInfo, *, cache_len: int = 0,
                     seq_shard_attn: bool = False) -> dict[str, P]:
    """Logical activation name -> partition spec (see the ``shard``
    calls in ``models``).

    ``seq_shard_attn``: when query heads cannot shard over the model axis
    (smollm 15H), shard the attention *sequence* dim instead (context
    parallel).  Only valid for S > 1 paths."""
    dp = tuple(mi.dp) or None
    tp = mi.tp
    tp_n = mi.tp_size
    heads_div = cfg.n_heads_p % tp_n == 0
    heads_ax = tp if heads_div else None
    kv_ax = tp if cfg.n_kv_heads % tp_n == 0 else None
    q_spec = (P(dp, None, heads_ax, None) if heads_div or not seq_shard_attn
              else P(dp, tp, None, None))
    # KV cache: prefer head sharding; fall back to sequence sharding.
    if kv_ax is not None:
        cache_spec = P(dp, None, kv_ax, None)
    elif cache_len and cache_len % tp_n == 0:
        cache_spec = P(dp, tp, None, None)
    else:
        cache_spec = P(dp, None, None, None)
    ep = cfg.n_experts > 0 and cfg.n_experts % tp_n == 0
    return {
        "act": P(dp, None, None),
        "act_ff": P(dp, None, tp),
        "act_heads": q_spec,
        "act_kv": P(dp, None, kv_ax, None),
        "cache": cache_spec,
        "logits": P(dp, None, tp),
        "batch": P(dp, None),
        # MoE dispatch buffers: (B, E, C, D) / (B, E, C, F)
        "moe_disp": P(dp, tp if ep else None, None, None),
        "moe_ff": P(dp, tp if ep else None, None, None if ep else tp),
        # mamba / rg-lru inner activations: (B, S, d_inner)
        "act_inner": P(dp, None, tp),
        # recurrent states: (B, d_inner[, N]) / (B, d_rnn)
        "state": P(dp, tp),
    }


def make_ctx(cfg, mi: MeshInfo, *, cache_len: int = 0,
             seq_shard_attn: bool = False) -> ShardingCtx:
    return ShardingCtx(mi=mi, act_specs=activation_specs(
        cfg, mi, cache_len=cache_len, seq_shard_attn=seq_shard_attn))


def cache_pspecs(cfg, cache_tree, mi: MeshInfo, *, cache_len: int = 0):
    """Partition specs for decode caches (leaves: k/v, conv, h).  The
    port's caches are a list (one entry a group) of nested dicts whose
    leaves stack the group's layers on a leading axis, as the
    reference's."""
    acts = activation_specs(cfg, mi, cache_len=cache_len)
    dp, tp, tp_n = tuple(mi.dp) or None, mi.tp, mi.tp_size
    inner_ax = tp if cfg.d_inner % tp_n == 0 else None
    rnn_ax = tp if cfg.d_rnn_ % tp_n == 0 else None

    def spec_of(names, leaf):
        name = names[-1] if names else None
        nd = len(leaf.shape)
        if name in ("k", "v"):
            rule = tuple(acts["cache"])
        elif name == "conv":
            ax = rnn_ax if cfg.family == "hybrid" else inner_ax
            rule = (dp, None, ax)
        elif name == "h":
            # mamba h: (B, Di, N); rg-lru h: (B, D_rnn)
            rule = (dp, inner_ax, None) if cfg.family == "ssm" \
                else (dp, rnn_ax)
        else:
            rule = (dp,)
        rule = tuple(rule)[:nd]
        pad = nd - len(rule)
        return P(*((None,) * pad + rule))

    if isinstance(cache_tree, list):
        return [_map(spec_of, c) for c in cache_tree]
    return _map(spec_of, cache_tree)


def batch_pspecs(batch_tree, mi: MeshInfo):
    """Batch inputs: leading dim over the data axes, rest replicated."""
    dp = tuple(mi.dp) or None
    return _map(lambda _, leaf: P(*((dp,) + (None,) * (len(leaf.shape) - 1))),
                batch_tree)
