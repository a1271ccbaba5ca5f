"""Training step: loss, microbatch gradient accumulation, optimizer update.

Counterpart of ``repro/runtime/train_step.py``. The step consumes a global
batch dict {"inputs": (B,S), "labels": (B,S)} of int64 tensors on the
params' device and runs ``accum_steps`` microbatches in a Python loop (the
reference's ``lax.scan``), accumulating grads in ``cfg.grad_accum_dtype``;
then global-norm clipping and the optimizer update, AdamW or Adafactor
(momentum 0.9, bf16) per the arch config, as the reference picks them.
A config with ``mtp_depth`` (deepseek-v3-671b) adds DeepSeek-V3's
multi-token-prediction loss at weight 0.3, as the reference does. A
config with an encoder or a cross source (whisper-large-v3,
llama-3.2-vision-90b) takes the batch's float ``enc_input`` (B, encoder_seq,
encoder_dim), sliced into microbatches with the tokens. Eager: there is no
jit, and the state is replaced, not donated.

The same step is the SPMD step, the counterpart of the reference's
``jax.jit(make_train_step(...), in_shardings=(state, batch),
out_shardings=(state, None))`` under ``use_rules`` (``launch/dryrun.py``):
given a state placed as DTensors with ``state_logical_axes`` and a batch
placed with ``batch_axes`` (``launch/sharding.py::place_tree``; an
``enc_input`` split over the batch like the tokens), and run
under ``use_rules(rules)``, every op runs on DTensors. The reference's
constraints on the stacked and the single microbatches redistribute them
(``_micro_slices``), the loss's mean is summed over the ranks' rows
(``_sharded_cross_entropy``), the gradient norm reduces through DTensor's
partial sums, and the optimizer hands each leaf back in its input leaf's
placements; the loss and grad norm come back replicated. On a mesh of one
device the step is the eager step bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.launch import sharding
from repro_torch.models import transformer
from repro_torch.models.common import (DTYPES, map_tree, padded_vocab,
                                      tree_leaves, zip_map)
from repro_torch.optim.adafactor import Adafactor, AdafactorState
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.grad import clip_by_global_norm
from repro_torch.optim.schedule import warmup_cosine


# the weight of the multi-token-prediction loss, as the reference's
MTP_WEIGHT = 0.3


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def make_optimizer(cfg, *, peak_lr=3e-4, warmup=200, total=10_000):
    sched = warmup_cosine(peak_lr, warmup, total)
    if cfg.optimizer == "adafactor":
        return Adafactor(lr=sched, momentum=0.9)
    state_dtype = ("bfloat16" if cfg.grad_accum_dtype == "bfloat16"
                   else "float32")
    return AdamW(lr=sched, state_dtype=state_dtype)


def init_train_state(cfg, model, optimizer, seed: int = 0,
                     device="cuda") -> TrainState:
    """Params drawn from a generator seeded with ``seed`` on ``device``
    (the reference takes a PRNG key), and the optimizer's zero state."""
    params = model.init(seed, device=device)
    return TrainState(params=params, opt_state=optimizer.init(params))


def state_logical_axes(cfg, model, optimizer):
    """Logical-axis tree matching TrainState(params, opt_state): optimizer
    state mirrors param axes (factored Adafactor moments drop the factored
    dim's annotation), in the port's ``AdamWState`` / ``AdafactorState``
    layouts, so its leaf paths are the checkpoint's."""
    descs = transformer.model_descs(cfg)
    p_axes = map_tree(lambda d: d.axes, descs)
    p_shapes = map_tree(lambda d: d.shape, descs)

    if isinstance(optimizer, AdamW):
        opt_axes = AdamWState(step=(), m=p_axes, v=p_axes)
    elif isinstance(optimizer, Adafactor):
        def vr_axes(a, s):
            return a[:-1] if len(s) >= 2 else a

        def vc_axes(a, s):
            return a[:-2] + (a[-1],) if len(s) >= 2 else (None,)

        def m_axes(a, s):
            return a if optimizer.momentum else (None,)

        opt_axes = AdafactorState(step=(),
                                  vr=zip_map(vr_axes, p_axes, p_shapes),
                                  vc=zip_map(vc_axes, p_axes, p_shapes),
                                  m=zip_map(m_axes, p_axes, p_shapes))
    else:
        raise TypeError(f"no state axes for {type(optimizer).__name__}")
    return TrainState(params=p_axes, opt_state=opt_axes)


def cross_entropy(logits, labels, vocab_size: int):
    """logits: (B,S,Vp) any dtype; labels: (B,S) int64. f32 stable xent
    over the padded vocabulary, as the reference computes it."""
    if sharding.is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels)
    return _CrossEntropy.apply(logits, labels)


def _sharded_cross_entropy(logits, labels):
    """The loss over DTensor logits: each rank takes its rows (the batch's
    placement) over the whole vocabulary; its share of the mean is its
    rows' mean times its share of the rows, and the shares are summed over
    the mesh dims that split the rows (DTensor's ``Partial``) into a
    replicated loss. Each rank's backward then gives its rows the gradient
    the whole version gives them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rules = sharding.active_rules()
    rows = logits.shape[0]
    axes = ("batch",) + (None,) * (logits.dim() - 1)
    _, l_pl = rules.sharding(axes, tuple(logits.shape))
    _, y_pl = rules.sharding(axes[:-1], tuple(labels.shape))
    out_pl = [Partial() if p.is_shard() else Replicate() for p in l_pl]

    def local(lg, y):
        return (_CrossEntropy.apply(lg, y) * (lg.shape[0] / rows),)

    loss, = local_map(local, out_placements=(tuple(out_pl),),
                      in_placements=(tuple(l_pl), tuple(y_pl)),
                      device_mesh=rules.mesh)(
        logits.redistribute(rules.mesh, l_pl),
        labels.redistribute(rules.mesh, y_pl))
    return loss.redistribute(rules.mesh, sharding.replicated(rules.mesh))


# rows of the logits whose f32 copy the loss holds at once. Autograd through
# ``logits.float()`` kept a whole f32 copy for the backward and formed the
# gradient in whole f32 tensors: at recurrentgemma-9b's 2 x 4096 tokens over
# 256,000 entries, 8.4 GB each, which took its train step to 72.85 GB of an
# H100's 79.18 GiB (chip_smoke.py phase 3b), where the caching allocator had
# to free and map memory again within the step
CE_ROWS = 1024


class _CrossEntropy(torch.autograd.Function):
    """The mean of logsumexp(l) - l[label] over rows, in f32, CE_ROWS rows
    at a time, saving the logits in their own dtype. The backward forms
    what autograd forms through the whole-tensor version, element for
    element in the same f32 operations: g exp(l - lse) with g = grad / rows
    (the mean's), minus g at each row's label (the gather's), cast to the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        rows = logits.reshape(-1, logits.shape[-1])
        index = labels.reshape(-1, 1)
        lse = torch.cat([torch.logsumexp(chunk.float(), dim=-1)
                         for chunk in rows.split(CE_ROWS)])
        gold = torch.gather(rows, -1, index)[:, 0].float()
        ctx.save_for_backward(rows, index, lse)
        ctx.shape = logits.shape
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        rows, index, lse = ctx.saved_tensors
        g = grad.expand(lse.shape) / lse.numel()
        out = torch.empty_like(rows)
        for i in range(0, rows.shape[0], CE_ROWS):
            r = slice(i, i + CE_ROWS)
            d = g[r, None] * (rows[r].float() - lse[r, None]).exp()
            d.scatter_add_(-1, index[r], -g[r, None])
            out[r] = d
        return out.view(ctx.shape), None


def _like(tree, leaves):
    """A dict tree of ``tree``'s structure holding ``leaves`` (sorted-key
    order, as ``tree_leaves`` lists them)."""
    return _fill(tree, iter(leaves))


def _fill(t, it):
    # module-level recursion: a closure that calls itself would keep the
    # leaves (the step's params and grads) alive until the garbage
    # collector runs
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    return next(it)


def _micro_slices(batch, accum_steps: int, mb: int):
    """Microbatch i holds rows i*mb .. (i+1)*mb - 1 of each batch tensor.
    Under a rule set, the stack of microbatches keeps its microbatch dim,
    not the accumulation dim, on the data axes, and each microbatch is
    constrained over "batch", as the reference constrains them. (A DTensor
    batch is gathered before it is split: its shards need not divide into
    whole microbatches.)"""
    def stack(x):
        return sharding.constrain(
            sharding.whole(x).reshape((accum_steps, mb) + x.shape[1:]),
            (None, "batch") + (None,) * (x.dim() - 1))

    stacked = {k: stack(x) for k, x in batch.items()}
    return [{k: sharding.constrain(x[i], ("batch",) + (None,) * (x.dim() - 2))
             for k, x in stacked.items()} for i in range(accum_steps)]


def make_train_step(cfg, model, optimizer, *, accum_steps: int = 1,
                    clip_norm: float = 1.0):
    vp = padded_vocab(cfg)
    adt = DTYPES[cfg.grad_accum_dtype]

    def loss_fn(params, micro):
        if cfg.mtp_depth:
            logits, mtp_logits = transformer.forward_with_mtp(
                cfg, params, micro["inputs"], micro.get("enc_input"))
            loss = cross_entropy(logits, micro["labels"], vp)
            # MTP target at position t is token t+2 = labels[t+1]
            mtp_loss = cross_entropy(mtp_logits, micro["labels"][:, 1:], vp)
            return loss + MTP_WEIGHT * mtp_loss
        logits = model.forward(params, micro["inputs"],
                               micro.get("enc_input"))
        return cross_entropy(logits, micro["labels"], vp)

    def loss_and_grads(leaves, params, micro):
        loss = loss_fn(params, micro)
        # each gradient in its param's placements: partial sums over ranks
        # are summed here, in the gradient's own dtype, before the
        # accumulation dtype's rounding and the optimizer's nonlinear ops
        return loss, [sharding.placed_like(g, p) for g, p in
                      zip(torch.autograd.grad(loss, leaves), leaves)]

    def train_step(state: TrainState, batch):
        b = batch["inputs"].shape[0]
        mb = b // accum_steps
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = _like(state.params, leaves)
        micros = _micro_slices(batch, accum_steps, mb)
        if accum_steps > 1:
            grads = [torch.zeros_like(p, dtype=adt) for p in leaves]
            loss = 0.0
            for micro in micros:
                l_i, g_i = loss_and_grads(leaves, params, micro)
                grads = [a + g.to(adt) / accum_steps
                         for a, g in zip(grads, g_i)]
                loss = loss + l_i.detach() / accum_steps
        else:
            loss, grads = loss_and_grads(leaves, params, micros[0])
            loss = loss.detach()
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(_like(state.params, grads),
                                               clip_norm)
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        metrics = {"loss": loss, "grad_norm": gnorm}
        return TrainState(params=params, opt_state=opt_state), metrics

    return train_step
