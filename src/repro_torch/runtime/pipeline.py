"""Merged-pipeline execution across ranks (port of ``repro/runtime/pipeline.py``).

The reference gives its mesh a leading ``stage`` axis and reshapes the
scanned layer stack ``[R, ...]`` to ``[n_stages, R/S, ...]``, so stage
``s`` owns the Scope *cluster* of repeats ``s·R/S .. (s+1)·R/S - 1``
(every pattern slot of each).  Here a mesh is a grid of processes
(``launch/mesh.py``): the rank at stage ``s`` holds a :class:`StageModel`,
layers ``s·(R/S)·P .. (s+1)·(R/S)·P - 1`` of the port's per-layer blocks
(P the pattern length) and the embedding, final norm and head, which are
replicated over ``stage`` as the reference's are.

GPipe schedule over ``n_micro`` microbatches (:func:`gpipe_beats`): at beat
``t`` stage ``s`` works on microbatch ``t - s``; stage 0 embeds fresh
microbatches, a later stage takes what stage ``s - 1`` sent it over the
``stage`` edge at beat ``t - 1`` (:meth:`Collectives.permute
<repro_torch.runtime.collectives.Collectives.permute>`, the counterpart of
``jax.lax.ppermute``).  ``n_micro + n_stages - 1`` beats, paper Eq. 2's
``m + N_cluster - 1``.  The reference also computes at the idle beats of
the fill and drain and sends on a wraparound edge whose result it ignores;
the port skips both, which changes no result.  Blocks run at positions
``0..S-1`` with no activation checkpointing, as the reference's pipeline
runs them whatever ``cfg.remat`` says.  Each rank takes its ``data`` rows
of every microbatch.  The last stage's hidden states reach every stage
through an all-reduce over ``stage`` of zeros elsewhere (the reference's
``psum``); the final norm, head and softcap then run on every rank.

The train step (:func:`build_pipeline_train_step`) runs GPipe's backward in
reverse beat order: each stage keeps every microbatch's input and output
until that microbatch's backward, the last stage starts from the head's
gradient, and each stage sends its input's gradient to ``s - 1`` over the
same edges.  Block gradients are summed over ``data``.  The replicated
leaves end with the plain gradient: the head's part, the same on every
stage, is summed over ``data`` only; the embedding lookup's part, which
only stage 0 has, is summed over ``data`` there and then over ``stage``.
The update is the reference's SGD.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.config import ModelConfig
from ..models.layers import dense, embed, rmsnorm, softcap
from ..models.model import DecoderLM, check_supported


def stage_layers(cfg: ModelConfig, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` owns: its ``R / n_stages``
    pattern repeats, every slot of each."""
    R, P = cfg.pattern_repeats, len(cfg.expanded_pattern)
    if R % n_stages:
        raise ValueError(f"{cfg.name}: {R} pattern repeats do not split over {n_stages} "
                         "pipeline stages")
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} of {n_stages}")
    per = R // n_stages * P
    return range(stage * per, (stage + 1) * per)


class StageModel(nn.Module):
    """One stage's piece of a :class:`DecoderLM`: the blocks of its layers
    (:func:`stage_layers`) and the replicated ``embed``, ``final_ln`` and
    ``lm_head``, the model's own tensors (nothing is copied: drop the whole
    model and the other stages' blocks are freed)."""

    def __init__(self, model: DecoderLM, n_stages: int, stage: int):
        super().__init__()
        if model.shard is not None:
            raise ValueError("a pipeline stage is cut from a whole model, not a rank's shard")
        self.cfg = model.cfg
        self.n_stages, self.stage = n_stages, stage
        self.layers = stage_layers(model.cfg, n_stages, stage)
        self.embed = model.embed
        self.blocks = nn.ModuleList(model.blocks[i] for i in self.layers)
        self.final_ln = model.final_ln
        self.register_parameter("lm_head", model.lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """This stage's layers on ``x`` [mb, S, d] at positions 0..S-1."""
        for blk in self.blocks:
            x, _ = blk.prefill(x, None)
        return x

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm, head and softcap of hidden states: fp32 logits."""
        h = rmsnorm(h, self.final_ln, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return softcap(dense(h, head).float(), self.cfg.logit_softcap)


def gpipe_beats(n_micro: int, n_stages: int) -> list[list[tuple[int, int]]]:
    """The forward schedule: beat ``t`` is the ``(stage, microbatch)`` pairs
    that work in it, ``(s, t - s)``; ``n_micro + n_stages - 1`` beats."""
    return [[(s, t - s) for s in range(n_stages) if 0 <= t - s < n_micro]
            for t in range(n_micro + n_stages - 1)]


def _backward_beats(n_micro: int, n_stages: int) -> list[list[tuple[int, int]]]:
    """The forward schedule mirrored: the last stage starts with the last
    microbatch, and stage ``s`` works on microbatch ``m`` at the beat where
    stage ``S-1-s`` works on ``n_micro-1-m`` forward."""
    return [[(n_stages - 1 - s, n_micro - 1 - m) for s, m in beat]
            for beat in gpipe_beats(n_micro, n_stages)]


def _stage_of(model, mesh, n_stages: int) -> StageModel:
    if mesh.shape.get("stage") != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh of {mesh.shape}: the mesh's 'stage' "
                         "axis is the stage count")
    stage = mesh.index("stage")
    if isinstance(model, DecoderLM):
        model = StageModel(model, n_stages, stage)
    if model.n_stages != n_stages or model.stage != stage:
        raise ValueError(f"stage {model.stage} of {model.n_stages} run by the rank at stage "
                         f"{stage} of {n_stages}")
    if model.device.type != mesh.device.type:
        raise ValueError(f"model on {model.device}, mesh ranks on {mesh.device}")
    return model


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``data`` rows of each microbatch of ``x`` [n_micro, mb, ...]."""
    n = mesh.shape.get("data", 1)
    mb = x.shape[1]
    if mb % n:
        raise ValueError(f"microbatch of {mb} rows does not split over the {n} ranks of the "
                         "data axis")
    i = mesh.index("data") if n > 1 else 0
    return x[:, i * mb // n:(i + 1) * mb // n]


def _run_stages(model: StageModel, tokens: torch.Tensor, mesh, table: torch.Tensor,
                keep: bool):
    """The GPipe forward of one rank on its rows ``tokens`` [n_micro, mb, S]:
    ``(hidden, ins, outs)``, the last stage's hidden states [n_micro, mb, S,
    d] on every rank and, with ``keep``, each microbatch's input and output
    of this stage (their graphs kept).  Stage 0 embeds through ``table``."""
    comm, s, ns = mesh.comm, model.stage, model.n_stages
    n_micro, mb, S = tokens.shape
    shape = (mb, S, model.cfg.d_model)
    blank = torch.empty(shape, dtype=model.embed.dtype, device=model.device)
    ins: list = [None] * n_micro
    outs: list = [None] * n_micro
    recv = None
    for beat in gpipe_beats(n_micro, ns):
        y = None
        for st, m in beat:
            if st != s:
                continue
            x = embed(tokens[m], table) if s == 0 else recv
            if keep and s > 0:
                x.requires_grad_()
            y = model.run_blocks(x)
            if keep:
                ins[m] = x
            if keep or s == ns - 1:
                outs[m] = y
        pairs = [(st, st + 1) for st, _ in beat if st + 1 < ns]
        recv = comm.permute(blank if y is None else y, "stage", pairs, tag="fwd")
    if s == ns - 1:
        hidden = torch.stack([o.detach() for o in outs])
    else:
        hidden = blank.new_zeros((n_micro, *shape))
    hidden = comm.all_reduce(hidden, axis="stage", tag="hidden")
    return hidden, ins, outs


def pipeline_forward(model, tokens: torch.Tensor, mesh, n_stages: int) -> torch.Tensor:
    """Pipelined forward of this rank of a ``(stage, data)`` mesh: ``tokens``
    [n_micro, mb, S] (global, on any device) -> this rank's logits
    ``[n_micro, mb / n_data, S, padded_vocab]`` fp32, on the mesh's device
    (:func:`gather_pipeline_logits` assembles the global ones).  ``model``
    is the rank's :class:`StageModel`, or the whole model, which is then cut
    (sharing its tensors).  No gradient is recorded."""
    model = _stage_of(model, mesh, n_stages)
    check_supported(model.cfg)
    tokens = _rows(torch.as_tensor(tokens), mesh).to(model.device, torch.int64)
    with torch.inference_mode():
        hidden, _, _ = _run_stages(model, tokens, mesh, model.embed, keep=False)
        return model.logits(hidden)


def gather_pipeline_logits(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The global logits [n_micro, mb, S, V] from each rank's rows."""
    return mesh.comm.all_gather(logits, dim=1, axis="data", tag="gather")


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).sum()


def build_pipeline_train_step(cfg: ModelConfig, mesh, n_stages: int, n_micro: int,
                              lr: float = 1e-3):
    """``step(model, batch) -> (model, loss)``: one SGD step of the pipeline
    on this rank.  ``model`` is the rank's :class:`StageModel`; ``batch``
    ``{"tokens", "labels"}`` [n_micro, mb, S], global.  The loss is the mean
    NLL over all ``n_micro x mb x S`` tokens (fp32, the same on every rank);
    the parameters are updated in place, ``(p - lr * g)`` in fp32 rounded to
    their dtype, and keep their summed gradient in ``.grad`` until the next
    step."""
    check_supported(cfg)

    def step(model: StageModel, batch: dict):
        model = _stage_of(model, mesh, n_stages)
        if model.cfg != cfg:
            raise ValueError(f"step built for {cfg.name}, called with {model.cfg.name}")
        dev, comm, s = model.device, mesh.comm, model.stage
        tokens = _rows(torch.as_tensor(batch["tokens"]), mesh).to(dev, torch.int64)
        labels = _rows(torch.as_tensor(batch["labels"]), mesh).to(dev, torch.int64)
        if tokens.shape[0] != n_micro:
            raise ValueError(f"step built for {n_micro} microbatches, batch has "
                             f"{tokens.shape[0]}")
        n_tokens = n_micro * tokens.shape[1] * mesh.shape.get("data", 1) * tokens.shape[2]
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
            p.grad = None
        # the lookup's gradient apart from the tied head's: they are reduced
        # over different axes
        table = model.embed.detach().requires_grad_(s == 0)
        with torch.enable_grad():
            hidden, ins, outs = _run_stages(model, tokens, mesh, table, keep=True)
            nll = torch.zeros((), dtype=torch.float32, device=dev)
            dh = []
            for m in range(n_micro):           # the head, one microbatch at a time
                h = hidden[m].detach().requires_grad_()
                part = _nll_sum(model.logits(h), labels[m])
                (part / n_tokens).backward()
                nll += part.detach()
                dh.append(h.grad)
            del hidden
            recv = None
            for beat in _backward_beats(n_micro, n_stages):
                dx = None
                for st, m in beat:
                    if st != s:
                        continue
                    torch.autograd.backward(outs[m], dh[m] if s == n_stages - 1 else recv)
                    dx = ins[m].grad if s > 0 else None
                    ins[m] = outs[m] = None
                pairs = [(st, st - 1) for st, _ in beat if st > 0]
                recv = comm.permute(dh[0] if dx is None else dx, "stage", pairs, tag="bwd")
        grads = {}
        for p in params:
            if p is model.embed:
                continue
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[p] = comm.all_reduce(g, axis="data", tag="grad")
        lookup = table.grad if s == 0 else torch.zeros_like(model.embed)
        if s == 0:                             # zeros on the other stages: nothing to sum
            lookup = comm.all_reduce(lookup, axis="data", tag="grad")
        g = comm.all_reduce(lookup, axis="stage", tag="grad")
        if model.embed.grad is not None:       # the tied head's part
            g = comm.all_reduce(model.embed.grad, axis="data", tag="grad") + g
        grads[model.embed] = g
        loss = comm.all_reduce(nll, axis="data", tag="loss") / n_tokens
        with torch.no_grad():
            for p, g in grads.items():
                p.copy_((p.float() - lr * g.float()).to(p.dtype))
                p.grad = g
        return model, loss

    return step
