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

Under ``decode`` (the batch over data, the KV sequence over model) the
dense layers' hops are the train forms at ``t`` tokens.  Under
``decode_long`` the batch is whole on every shard (``n = b t``): a
column-parallel product against a weight split over data contracts each
shard's slice of the input (a split, no bytes) and all-reduces the (n, N /
tp) partial sums over data; a row-parallel one all-reduces its (n, D /
dp) partial sums over the model axis and all-gathers them over data.  On
top of those (:func:`decode_hops`):

* self-attention against a cache split over the KV axes: q and the new
  K/V rows all-gathered over the model axis (heads whole), then the
  combine over each KV axis, an all-reduce of the (b_loc Hq t) f32 row
  maxima and one of the (b_loc Hq t (Dh + 1)) f32 rescaled numerators and
  denominators;
* cross-attention over frames split over the KV axes: q's heads
  all-gathered, ``wk`` and ``wv`` all-gathered whole (over data, then
  model), and the same combine;
* RWKV: the previous token all-gathered over the model axis (b_loc D /
  tp) and, where the heads split, the new state (b_loc H / tp Dh², f32);
  RG-LRU: the new state (b_loc d_rnn / tp, f32).

The encoder-decoder arch adds, under train and prefill rules, the
encoder's attention and MLP layers at the frames' length and a
cross-attention a decoder layer whose K/V columns run over the frames.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["Forms", "forward_hops", "layer_hops", "train_hops", "decode_hops",
           "MODES"]

#: The modes of :func:`layer_hops`: the rules it is sharded by.
MODES = ("train", "prefill", "decode", "decode_long")


class Forms:
    """A tally of closed-form hops on a ``dp`` x ``tp`` mesh."""

    def __init__(self, dp: int, tp: int, mode: str = "train"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.dp, self.tp, self.mode = dp, tp, mode
        #: whether the batch is split over data (all modes but decode_long)
        self.batch_split = mode != "decode_long"
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
        if g:
            return
        if self.batch_split:
            self.a2a("data", n * d, itemsize)
            self.rs("data", self.dp * n * cols // self.tp, itemsize)
        else:
            self.ar("data", n * cols // self.tp, itemsize)

    def row(self, n, k, d, itemsize, g):
        """h (n, k / tp) @ w (k, d) split (model, data), all-reduced back
        onto the residual's layout."""
        self.weight(k, d, itemsize, g=g)
        if g:
            self.ar("model", n * d, itemsize)
        elif self.batch_split:
            self.ag("data", n * k // self.tp, itemsize)
            self.ar("model", n * d, itemsize)
            self.a2a("data", n * d, itemsize)
        else:
            self.ar("model", n * d // self.dp, itemsize)
            self.ag("data", n * d // self.dp, itemsize)

    def kv_axes(self):
        """The KV sequence's mesh axes under the mode."""
        return {"decode": ("model",), "decode_long": ("data", "model")}.get(self.mode, ())

    def combine(self, rows, hd, axes):
        """The softmax combine of ``rows`` (b_loc Hq t) over ``axes``."""
        for a in axes:
            self.ar(a, rows, 4, grad=False)
            self.ar(a, rows * (hd + 1), 4, grad=False)


def layer_hops(cfg, kind: str, dp: int, tp: int, b: int, t: int, itemsize: int,
               forms: Forms | None = None, *, mode: str = "train",
               s_kv: int | None = None) -> Counter:
    """The collectives of one forward call of a layer ``kind`` under
    ``mode``'s rules (``forms``' mode where given): ``"mlp"``, ``"attn"``
    (any attention kind; against a split cache under the decode modes),
    ``"cross"`` (cross-attention over ``s_kv`` frames a row), ``"rwkv"``,
    ``"rec"`` (with their state's hops under the decode modes), ``"moe"``
    (the gather path), ``"moe_a2a"``, ``"embed"``, ``"logits"`` or
    ``"loss"``."""
    f = forms or Forms(dp, tp, mode)
    g = cfg.fsdp_gather_weights
    b_loc = b // dp if f.batch_split else b
    d, n = cfg.d_model, b_loc * t
    decoding = f.mode in ("decode", "decode_long")
    if kind == "mlp":
        gated = cfg.mlp_type in ("swiglu", "geglu")
        for _ in range(2 if gated else 1):
            f.column(n, d, cfg.d_ff, itemsize, g)
        f.row(n, cfg.d_ff, d, itemsize, g)
    elif kind in ("attn", "cross"):
        from repro_torch.model.attention import heads_plan

        nq, nkv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
        n_kv = b_loc * (s_kv if kind == "cross" else t)
        f.column(n, d, nq * hd, itemsize, g)
        if kind == "cross" and decoding:                       # frames split over kv_seq
            f.ag("model", n * nq * hd // tp, itemsize)         # q's heads whole
            for _ in range(2):                                 # wk, wv whole
                f.ag("data", d * nkv * hd // dp // tp, itemsize)
                f.ag("model", d * nkv * hd // tp, itemsize)
                if cfg.qkv_bias:
                    f.ag("model", nkv * hd // tp, itemsize)
            f.combine(b_loc * nq * t, hd, f.kv_axes())
        elif decoding:                                         # a cache split over kv_seq
            for _ in range(2):
                f.column(n, d, nkv * hd, itemsize, g)
            f.ag("model", n * nq * hd // tp, itemsize)         # q and the new K/V rows,
            f.ag("model", n * nkv * hd // tp, itemsize)        # heads whole
            f.ag("model", n * nkv * hd // tp, itemsize)
            f.combine(b_loc * nq * t, hd, f.kv_axes())
        else:
            plan = heads_plan(nq, nkv, tp)
            for _ in range(2):
                f.column(n_kv, d, nkv * hd, itemsize, g)
            if plan == "replicate":
                f.ag("model", n * nq * hd // tp, itemsize)
            if plan != "split":
                f.ag("model", n_kv * nkv * hd // tp, itemsize)
                f.ag("model", n_kv * nkv * hd // tp, itemsize)
        f.row(n, nq * hd, d, itemsize, g)
    elif kind == "rwkv":
        if decoding:
            f.ag("model", b_loc * d // tp, itemsize)          # the previous token, whole
        f.ag("data", 5 * d // dp, itemsize)                   # mu, for the token shift
        for _ in range(4):                                     # r, k, v, g
            f.column(n, d, d, itemsize, g)
        if f.batch_split:                                      # the decay LoRA's first
            f.a2a("data", n * d, itemsize)                     # product, never gathered
            f.rs("data", dp * n * 64, itemsize)
        else:
            f.ar("data", n * 64, itemsize)
        if (d // 64) % tp:                                     # heads gathered whole:
            for _ in range(4):                                 # r, k, v, the decay's delta
                f.ag("model", n * d // tp, itemsize)
            for _ in range(2):                                 # its base and the bonus u
                f.ag("model", d // tp, itemsize)
        else:
            if decoding:                                       # the new state, whole
                f.ag("model", b_loc * d // 64 // tp * 64 * 64, 4)
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
            elif f.batch_split:
                f.ag("data", n * r // tp, itemsize)
                f.ag("model", dp * n * r // tp, itemsize)
                f.rs("data", dp * n * r // tp, itemsize)
            else:
                f.ag("model", n * r // tp, itemsize)
                f.ar("data", n * r // tp, itemsize)
        if decoding:
            f.ag("model", b_loc * r // tp, 4)                  # the new state, whole
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
            if f.batch_split:
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
        elif f.batch_split:
            f.ag("data", n, 8, grad=False)                     # the token ids
            f.ar("model", n * d, itemsize)
            f.a2a("data", n * d, itemsize)
        else:
            f.ar("model", n * d // dp, itemsize)
            f.ag("data", n * d // dp, itemsize)
    elif kind == "logits":
        v = cfg.padded_vocab
        if g:
            f.weight(v, d, itemsize)
        elif f.batch_split:
            f.a2a("data", n * d, 4)
            f.rs("data", dp * n * v // tp, 4)
        else:
            f.ar("data", n * v // tp, 4)
    elif kind == "loss":
        f.ar("model", n, 4, grad=False)                        # the max, taken detached
        for _ in range(2):                                     # sum of exps, label logit
            f.ar("model", n, 4)
        f.ar("data", 1, 4)
    else:
        raise ValueError(kind)
    return f.hops


def forward_hops(cfg, dp: int, tp: int, b: int, t: int, itemsize: int, *,
                 loss: bool = False, s_enc: int | None = None) -> Counter:
    """The collectives of one sharded forward (embedding, every layer, the
    logits and, with ``loss``, the cross-entropy); for the
    encoder-decoder arch, the encoder over ``s_enc`` frames a row first and
    a cross-attention in every decoder layer."""
    return forward_hops_into(cfg, Forms(dp, tp), b, t, itemsize, loss=loss,
                             s_enc=s_enc).hops


def decode_hops(cfg, dp: int, tp: int, b: int, t: int, itemsize: int, mode: str = "decode",
                *, s_enc: int | None = None) -> Counter:
    """The collectives of one sharded ``decode_step`` window of ``t``
    tokens under ``mode`` (``"decode"`` or ``"decode_long"``): the
    embedding, every decoder layer against its split state (with its
    cross-attention over ``s_enc`` split frames a row, for the
    encoder-decoder arch) and the logits."""
    f = Forms(dp, tp, mode)
    layer_hops(cfg, "embed", dp, tp, b, t, itemsize, f)
    ffn = ("moe_a2a" if cfg.moe_impl == "a2a" and t % tp == 0 else "moe") \
        if cfg.num_experts else "mlp"
    for kind in cfg.layer_kinds:
        layer_hops(cfg, "attn" if kind in ("attn", "local", "global") else kind,
                   dp, tp, b, t, itemsize, f)
        if cfg.is_enc_dec:
            layer_hops(cfg, "cross", dp, tp, b, t, itemsize, f, s_kv=s_enc)
        layer_hops(cfg, ffn, dp, tp, b, t, itemsize, f)
    layer_hops(cfg, "logits", dp, tp, b, t, itemsize, f)
    return f.hops


_TRANSPOSE = {"all_gather": "reduce_scatter", "reduce_scatter": "all_gather",
              "all_reduce": "all_reduce", "all_to_all": "all_to_all"}


def train_hops(cfg, dp: int, tp: int, b: int, t: int, itemsize: int, leaves, *,
               s_enc: int | None = None) -> Counter:
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
    parameter's ``(local elements, replicated axes)``; ``s_enc``: the
    encoder-decoder arch's frames a row."""
    m = max(1, cfg.microbatch)
    bm = b // m
    fwd = forward_hops_into(cfg, Forms(dp, tp), bm, t, itemsize, loss=True, s_enc=s_enc)
    total = Counter()
    for key, n in fwd.hops.items():
        total[key] += n * m
        back = n - fwd.nograd.get(key, 0)
        if back:
            kind, axis, el, size = key
            total[(_TRANSPOSE[kind], axis, el, size)] += back * m
    if cfg.remat != "none":
        from repro_torch.model.transformer import plan_groups

        ffn = ("moe_a2a" if cfg.moe_impl == "a2a" else "moe") if cfg.num_experts else "mlp"
        pattern, n_periods, _ = plan_groups(cfg)
        # (period kinds, periods, tokens a row, feed-forward, cross-attention)
        stacks = [(pattern, n_periods, t, ffn, cfg.is_enc_dec)]
        if cfg.is_enc_dec:            # the encoder's: attention and the MLP a layer
            stacks.append((("attn",), cfg.encoder_layers, s_enc, "mlp", False))
        for pattern, n_periods, tt, ffn_k, cross in stacks:
            f = Forms(dp, tp)
            for kind in pattern:
                layer_hops(cfg, "attn" if kind in ("attn", "local", "global") else kind,
                           dp, tp, bm, tt, itemsize, f)
                if cross:
                    layer_hops(cfg, "cross", dp, tp, bm, tt, itemsize, f, s_kv=s_enc)
                layer_hops(cfg, ffn_k, dp, tp, bm, tt, itemsize, f)
            # The recompute stops at the period's last saved tensor (the
            # checkpoint's early stop): its last feed-forward's output is not
            # reduced again.
            n = bm // dp * tt
            if ffn_k == "mlp":
                tail = [("all_reduce", "model", n * cfg.d_model * 2 * (tp - 1) // tp, itemsize)]
                if not cfg.fsdp_gather_weights:
                    tail.append(("all_to_all", "data", n * cfg.d_model // dp * (dp - 1),
                                 itemsize))
            elif ffn_k == "moe":
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


def forward_hops_into(cfg, f: Forms, b: int, t: int, itemsize: int, *, loss: bool = False,
                      s_enc: int | None = None):
    """:func:`forward_hops` tallied into ``f`` (its ``nograd`` too)."""
    if cfg.is_enc_dec:
        for _ in range(cfg.encoder_layers):
            layer_hops(cfg, "attn", f.dp, f.tp, b, s_enc, itemsize, f)
            layer_hops(cfg, "mlp", f.dp, f.tp, b, s_enc, itemsize, f)
    layer_hops(cfg, "embed", f.dp, f.tp, b, t, itemsize, f)
    ffn = ("moe_a2a" if cfg.moe_impl == "a2a" else "moe") if cfg.num_experts else "mlp"
    for kind in cfg.layer_kinds:
        mixer = "attn" if kind in ("attn", "local", "global") else kind
        layer_hops(cfg, mixer, f.dp, f.tp, b, t, itemsize, f)
        if cfg.is_enc_dec:
            layer_hops(cfg, "cross", f.dp, f.tp, b, t, itemsize, f, s_kv=s_enc)
        layer_hops(cfg, ffn, f.dp, f.tp, b, t, itemsize, f)
    layer_hops(cfg, "logits", f.dp, f.tp, b, t, itemsize, f)
    if loss:
        layer_hops(cfg, "loss", f.dp, f.tp, b, t, itemsize, f)
    return f
