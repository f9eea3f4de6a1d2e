"""Closed forms of the sharded dense layers' collectives.

Each function gives, for one forward call of a layer kind on a (data,
model) mesh of ``dp`` x ``tp`` shards (train or prefill rules, a residual
stream of global batch ``b`` split over data, ``t`` tokens, ``d_model``
replicated), the collectives :mod:`repro_torch.model.sharding` makes: a
``Counter`` of ``(kind, axis, elements, itemsize)`` -> count, where
``elements`` is what each shard of a group sends (the ring forms of
:class:`repro_torch.core.device_comm.Hop`) and the count is the
collectives times the groups that run them (``tp`` groups along
``data``, ``dp`` along ``model``).  They are written from the layouts the
reference's rules give, not from the resharding code: the tests and
``chip_smoke.py`` phase 3r hold the logged hops to them.

With ``n = b / dp * t`` a shard's tokens and ``D`` the model width:

* a weight gathered for use (``fsdp_gather_weights``): an all-gather over
  data of its shard;
* a column-parallel product against a weight whose ``embed`` dim stays
  split over data: an all-to-all of the input over data ((dp - 1) / dp of
  n·D) and a reduce-scatter over data of the (b·t, N / tp) partial sums;
* a row-parallel product: an all-reduce over the model axis of the (n, D)
  partial sums, and, with the weight's ``embed`` dim split over data, an
  all-gather of the input over data before it and an all-to-all of the
  (n, D) result after it.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["Forms", "forward_hops", "layer_hops", "train_hops"]


class Forms:
    """A tally of closed-form hops on a ``dp`` x ``tp`` mesh."""

    def __init__(self, dp: int, tp: int):
        self.dp, self.tp = dp, tp
        self.hops: Counter = Counter()
        #: the hops whose inputs carry no gradient (token ids, the loss's
        #: max): their backward makes no transpose.
        self.nograd: Counter = Counter()

    def _n(self, axis):
        return self.dp if axis == "data" else self.tp

    def _add(self, kind, axis, elements, itemsize, grad=True):
        if self._n(axis) > 1:
            groups = self.tp if axis == "data" else self.dp
            self.hops[(kind, axis, int(elements), itemsize)] += groups
            if not grad:
                self.nograd[(kind, axis, int(elements), itemsize)] += groups

    def ag(self, axis, local, itemsize, grad=True):
        """All-gather of a shard of ``local`` elements."""
        self._add("all_gather", axis, local * (self._n(axis) - 1), itemsize, grad)

    def rs(self, axis, whole, itemsize):
        """Reduce-scatter of a shard's buffer of ``whole`` elements."""
        n = self._n(axis)
        self._add("reduce_scatter", axis, whole // n * (n - 1), itemsize)

    def ar(self, axis, numel, itemsize, grad=True):
        n = self._n(axis)
        self._add("all_reduce", axis, numel * 2 * (n - 1) // n, itemsize, grad)

    def a2a(self, axis, numel, itemsize):
        n = self._n(axis)
        self._add("all_to_all", axis, numel // n * (n - 1), itemsize)

    # -- the products ---------------------------------------------------------
    def weight(self, rows, cols, itemsize, g=True):
        """A (rows, cols) weight split over data on ``rows`` and over the
        model axis, gathered for use."""
        if g:
            self.ag("data", rows * cols // self.dp // self.tp, itemsize)

    def column(self, n, d, cols, itemsize, g):
        """x (n, d) @ w (d, cols) split (data, model), onto (data, ., model)."""
        self.weight(d, cols, itemsize, g=g)
        if not g:
            self.a2a("data", n * d, itemsize)
            self.rs("data", self.dp * n * cols // self.tp, itemsize)

    def row(self, n, k, d, itemsize, g):
        """h (n, k / tp) @ w (k, d) split (model, data), all-reduced back
        onto the residual's layout."""
        self.weight(k, d, itemsize, g=g)
        if g:
            self.ar("model", n * d, itemsize)
        else:
            self.ag("data", n * k // self.tp, itemsize)
            self.ar("model", n * d, itemsize)
            self.a2a("data", n * d, itemsize)


def layer_hops(cfg, kind: str, dp: int, tp: int, b: int, t: int, itemsize: int,
               forms: Forms | None = None) -> Counter:
    """The collectives of one forward call of a layer ``kind``:
    ``"mlp"``, ``"attn"`` (any attention kind), ``"rwkv"``, ``"rec"``,
    ``"moe"`` (the gather path), ``"moe_a2a"``, ``"embed"``, ``"logits"``
    or ``"loss"``."""
    f = forms or Forms(dp, tp)
    g = cfg.fsdp_gather_weights
    d, n = cfg.d_model, b // dp * t
    if kind == "mlp":
        gated = cfg.mlp_type in ("swiglu", "geglu")
        for _ in range(2 if gated else 1):
            f.column(n, d, cfg.d_ff, itemsize, g)
        f.row(n, cfg.d_ff, d, itemsize, g)
    elif kind == "attn":
        from repro_torch.model.attention import heads_plan

        nq, nkv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
        plan = heads_plan(nq, nkv, tp)
        for cols in (nq * hd, nkv * hd, nkv * hd):
            f.column(n, d, cols, itemsize, g)
        if plan == "replicate":
            f.ag("model", n * nq * hd // tp, itemsize)
        if plan != "split":
            f.ag("model", n * nkv * hd // tp, itemsize)
            f.ag("model", n * nkv * hd // tp, itemsize)
        f.row(n, nq * hd, d, itemsize, g)
    elif kind == "rwkv":
        f.ag("data", 5 * d // dp, itemsize)                   # mu, for the token shift
        for _ in range(4):                                     # r, k, v, g
            f.column(n, d, d, itemsize, g)
        f.a2a("data", n * d, itemsize)                         # the decay LoRA's first
        f.rs("data", dp * n * 64, itemsize)                    # product, never gathered
        if (d // 64) % tp:                                     # heads gathered whole:
            for _ in range(4):                                 # r, k, v, the decay's delta
                f.ag("model", n * d // tp, itemsize)
            for _ in range(2):                                 # its base and the bonus u
                f.ag("model", d // tp, itemsize)
        else:
            f.ar("model", n, 4)                                # the output norm's squares
        f.row(n, d, d, itemsize, g)
    elif kind == "rec":
        r = cfg.d_rnn
        f.column(n, d, r, itemsize, g)                         # w_y
        f.column(n, d, r, itemsize, g)                         # w_x
        for _ in range(2):                                     # gate_a, gate_x on the conv
            if g:
                f.weight(r, r, itemsize)
                f.ag("model", n * r // tp, itemsize)
            else:
                f.ag("data", n * r // tp, itemsize)
                f.ag("model", dp * n * r // tp, itemsize)
                f.rs("data", dp * n * r // tp, itemsize)
        f.row(n, r, d, itemsize, g)
    elif kind in ("moe", "moe_a2a"):
        from repro_torch.model.moe import capacity
        from repro_torch.model.moe_a2a import a2a_capacity

        e, ff = cfg.num_experts, cfg.d_ff
        if kind == "moe_a2a":
            f.ag("data", d * e // dp // tp, itemsize)          # the router, whole
            f.ag("model", d * e // tp, itemsize)
            for _ in range(3):                                 # the experts, gathered
                f.weight(e * d, ff, itemsize)
            cap = a2a_capacity(n // tp, cfg)
            f.a2a("model", e * cap * d, itemsize)
            f.a2a("model", e * cap * d, itemsize)
            f.ag("model", n // tp * d, itemsize)
        else:
            big = b * t                                        # every token of the call
            cap = capacity(big, cfg)
            f.ag("data", n * d, itemsize)
            if g:
                f.weight(d, e, itemsize)
            else:
                f.ar("data", big * e // tp, 4)
            f.ag("model", big * e // tp, 4)
            for _ in range(3):
                f.weight(e * d, ff, itemsize, g=g)
            if not g:
                f.ar("data", e // tp * cap * ff, itemsize)
                f.ar("data", e // tp * cap * ff, itemsize)
                f.ag("data", e // tp * cap * d // dp, itemsize)
            f.ar("model", n * d, 4)
    elif kind == "embed":
        v = cfg.padded_vocab
        if g:
            f.weight(v, d, itemsize)
            f.ar("model", n * d, itemsize)
        else:
            f.ag("data", n, 8, grad=False)                     # the token ids
            f.ar("model", n * d, itemsize)
            f.a2a("data", n * d, itemsize)
    elif kind == "logits":
        v = cfg.padded_vocab
        if g:
            f.weight(v, d, itemsize)
        else:
            f.a2a("data", n * d, 4)
            f.rs("data", dp * n * v // tp, 4)
    elif kind == "loss":
        f.ar("model", n, 4, grad=False)                        # the max, taken detached
        for _ in range(2):                                     # sum of exps, label logit
            f.ar("model", n, 4)
        f.ar("data", 1, 4)
    else:
        raise ValueError(kind)
    return f.hops


def forward_hops(cfg, dp: int, tp: int, b: int, t: int, itemsize: int, *,
                 loss: bool = False) -> Counter:
    """The collectives of one sharded forward (embedding, every layer, the
    logits and, with ``loss``, the cross-entropy) of a decoder-only arch."""
    return forward_hops_into(cfg, Forms(dp, tp), b, t, itemsize, loss=loss).hops


_TRANSPOSE = {"all_gather": "reduce_scatter", "reduce_scatter": "all_gather",
              "all_reduce": "all_reduce", "all_to_all": "all_to_all"}


def train_hops(cfg, dp: int, tp: int, b: int, t: int, itemsize: int, leaves) -> Counter:
    """The collectives of one sharded train step of ``cfg.microbatch``
    microbatches of a global batch ``b``: each microbatch's forward with
    its loss, the layers' forward again where ``remat`` recomputes the
    stacked periods (up to the last tensor the backward reads:
    ``torch.utils.checkpoint`` stops there, so a period's last
    feed-forward output is not reduced again), and the backward, which makes each forward hop's
    transpose (an all-gather's is a reduce-scatter of the same bytes and
    the other way round; an all-reduce's and an all-to-all's their own)
    save those of inputs that carry no gradient; then, once a step, an f32
    all-reduce of every gradient leaf over each mesh axis it is replicated
    on (the data-parallel all-reduce) and the clip's global norm, one
    element all-reduced over data and over model.  ``leaves``: each
    parameter's ``(local elements, replicated axes)``."""
    m = max(1, cfg.microbatch)
    bm = b // m
    fwd = forward_hops_into(cfg, Forms(dp, tp), bm, t, itemsize, loss=True)
    total = Counter()
    for key, n in fwd.hops.items():
        total[key] += n * m
        back = n - fwd.nograd.get(key, 0)
        if back:
            kind, axis, el, size = key
            total[(_TRANSPOSE[kind], axis, el, size)] += back * m
    if cfg.remat != "none":
        from repro_torch.model.transformer import plan_groups

        pattern, n_periods, _ = plan_groups(cfg)
        f = Forms(dp, tp)
        ffn = ("moe_a2a" if cfg.moe_impl == "a2a" else "moe") if cfg.num_experts else "mlp"
        for kind in pattern:
            layer_hops(cfg, "attn" if kind in ("attn", "local", "global") else kind,
                       dp, tp, bm, t, itemsize, f)
            layer_hops(cfg, ffn, dp, tp, bm, t, itemsize, f)
        # The recompute stops at the period's last saved tensor (the
        # checkpoint's early stop): its last feed-forward's output is not
        # reduced again.
        n = bm // dp * t
        if ffn == "mlp":
            tail = [("all_reduce", "model", n * cfg.d_model * 2 * (tp - 1) // tp, itemsize)]
            if not cfg.fsdp_gather_weights:
                tail.append(("all_to_all", "data", n * cfg.d_model // dp * (dp - 1), itemsize))
        elif ffn == "moe":
            tail = [("all_reduce", "model", n * cfg.d_model * 2 * (tp - 1) // tp, 4)]
        else:
            tail = [("all_gather", "model", n // tp * cfg.d_model * (tp - 1), itemsize)]
        for key in tail:
            if key[2]:
                f.hops[key] -= dp if key[1] == "model" else tp
        for key, count in f.hops.items():
            total[key] += count * m * n_periods
    f = Forms(dp, tp)
    for numel, replicated in leaves:
        for axis in ("data", "model"):
            if axis in replicated:
                f.ar(axis, numel, 4)
    f.ar("data", 1, 4)
    f.ar("model", 1, 4)
    total.update(f.hops)
    return +total


def forward_hops_into(cfg, f: Forms, b: int, t: int, itemsize: int, *, loss: bool = False):
    """:func:`forward_hops` tallied into ``f`` (its ``nograd`` too)."""
    layer_hops(cfg, "embed", f.dp, f.tp, b, t, itemsize, f)
    ffn = ("moe_a2a" if cfg.moe_impl == "a2a" else "moe") if cfg.num_experts else "mlp"
    for kind in cfg.layer_kinds:
        mixer = "attn" if kind in ("attn", "local", "global") else kind
        layer_hops(cfg, mixer, f.dp, f.tp, b, t, itemsize, f)
        layer_hops(cfg, ffn, f.dp, f.tp, b, t, itemsize, f)
    layer_hops(cfg, "logits", f.dp, f.tp, b, t, itemsize, f)
    if loss:
        layer_hops(cfg, "loss", f.dp, f.tp, b, t, itemsize, f)
    return f
