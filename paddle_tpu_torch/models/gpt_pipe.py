"""The pipelined GPT (↔ paddle_tpu/models/gpt_pipe.py): stacked decoder
parameters and the pipeline schedules of `parallel.pipeline`.

- **Parameters.** Every decoder parameter is one stacked [L, ...] tensor
  under the reference's name `stack__<name>` (`self_attn.q_proj.weight`
  -> `stack__self_attn__q_proj__weight`). The layers are built one at a
  time from the model's generator in the order `GPTForCausalLM` builds
  them, so a seed gives the layered model's weights
  (`stack_layered_state_dict` carries a layered state over). The token
  table, the position table, the final norm and an untied head are
  whole on every pp rank, as the reference's specs carry no pp.
- **The layer body** is the port's own `GPTDecoderLayer`, run through
  `torch.func.functional_call` on a template (layer 0's structure, its
  own tensors on the meta device) with each layer's slices of the stacks,
  as the reference runs its template (:138-156); the layered and the
  pipelined model cannot drift apart. LLaMA configs go through the same
  class.
- **Stages.** When a pp group reaches the model (a `DistributedTrainStep`
  over a mesh, or a global mesh at the first call) each rank keeps its
  stage's rows of every stack in place: L / S contiguous layers, or under
  VPP its V chunks of L / (S V) layers, virtual stages v * S + s
  (`parallel.pipeline.stage_rows`). The stacks are marked `pp_stage`
  (their gradients differ from stage to stage); the rest is shared over
  pp: stage 0 runs the embedding, the last stage the final norm, the head
  and the loss, and the training step sums the shared parameters'
  gradients over the pp group (a tied table sums its lookup's and its
  head's, as Paddle's SharedLayerDesc does). Over an mp group the stacks
  are cut where the template's layers are (`fleet.layers.mpu.shard_model`
  cuts both), and the activations sent between stages are [mb, S / mp, H]
  under sequence parallelism.
- **Entry points.** `forward` runs GPipe, or VPP with
  `pp_schedule="vpp"`, and gives every rank the logits (broadcast from
  the last stage, as the reference's result is replicated); each stage's
  graph is kept for the backward, with per-layer recompute under
  `use_recompute`. `forward_loss(input_ids, labels, criterion,
  *more_labels)` runs 1F1B (with `pp_schedule="1f1b"`): the mean over the
  microbatches of `criterion(logits_m, labels_m, ...)`, each microbatch's
  backward run inside, the stage body run again from its kept input (so
  `use_recompute` adds nothing). `jit.TrainStep` takes that route and
  weights each microbatch's loss so that one stage gives the criterion
  over the whole batch, as the reference's pp = 1 path does (:323-324).
  Microbatch m is rows [m B / M, (m + 1) B / M) at any pp size.

Unlike the reference under `amp.decorate(level="O2")`, the stacks of the
template's LayerNorm parameters stay in float32, as the layered model's
LayerNorm layers do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import env as _env
from ..distributed.fleet.layers.mpu.mp_layers import (ColumnParallelLinear,
                                                      VocabParallelEmbedding,
                                                      _cut, shard_model)
from ..distributed.fleet.recompute import recompute
from ..distributed.fleet.utils.sequence_parallel_utils import GatherOp
from ..nn import Dropout, Embedding, LayerNorm
from ..parallel.pipeline import (microbatch, pipeline_1f1b,
                                 pipeline_interleaved, pipeline_spmd,
                                 stage_rows, unmicrobatch)
from .gpt import (GPTConfig, GPTDecoderLayer, _check_supported, _embed,
                  _lm_logits, _make_norm)
from ..nn.layer.layers import Layer
from ..framework.core import Parameter

__all__ = ["GPTForCausalLMPipe", "stack_layered_state_dict",
           "unstack_to_layered_state_dict"]


def _stacked_name(template_name: str) -> str:
    return "stack__" + template_name.replace(".", "__")


class GPTForCausalLMPipe(Layer):
    """GPT/LLaMA causal LM with stacked decoder parameters and a pipeline
    schedule over the mesh's pp group (see the module docstring).

    num_microbatches: M (reference accumulate_steps). pp_schedule: "gpipe",
    "vpp" (with `vpp_degree` chunks a stage; num_layers must divide by
    pp * vpp_degree and M be at least pp) or "1f1b" (`forward_loss`, which
    `jit.TrainStep` calls; `forward` runs GPipe). `device`, `dtype` and
    `seed` as `GPTForCausalLM`'s."""

    mp_group = None

    def __init__(self, config: GPTConfig, num_microbatches: int = 4,
                 pp_schedule: str = "gpipe", vpp_degree: int = 1, *,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        _check_supported(config)
        if config.context_parallel:
            raise NotImplementedError(
                "a pipelined model under context parallelism is ported with "
                "ROADMAP queue A item 1f")
        if pp_schedule not in ("gpipe", "vpp", "1f1b"):
            raise ValueError(f"unknown pp_schedule {pp_schedule!r}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = dict(generator=gen, device=dev, dtype=dtype)
        std = config.initializer_range
        self.config = config
        self.num_microbatches = num_microbatches
        self.pp_schedule = pp_schedule
        self.vpp_degree = vpp_degree if pp_schedule == "vpp" else 1
        # GPTForCausalLM's order of draws: tables, layers, head
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, weight_std=std, **kw)
        if not config.use_rope:
            self.embed_positions = Embedding(
                config.max_position_embeddings, config.hidden_size,
                weight_std=std, **kw)
        self.embed_dropout = Dropout(config.hidden_dropout_prob)
        L = config.num_layers
        bufs = {}
        for i in range(L):
            layer = GPTDecoderLayer(config, **kw)
            for name, p in layer.named_parameters():
                if name not in bufs:
                    bufs[name] = torch.empty((L, *p.shape), dtype=p.dtype,
                                             device=dev)
                bufs[name][i].copy_(p.detach())
            if i == 0:
                template = layer
        self.final_norm = _make_norm(config, dev, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, weight_std=std, **kw)
        norms = {f"{m}.{n}" for m, mod in template.named_modules()
                 if isinstance(mod, LayerNorm)
                 for n, _ in mod.named_parameters(recurse=False)}
        self._param_names = list(bufs)
        for name, p in template.named_parameters():
            stacked = Parameter(bufs.pop(name))
            spec = getattr(p, "dist_attr", None) or (None,) * p.dim()
            stacked.dist_attr = ("pp", *spec)
            stacked.pp_stage = True
            stacked.keep_fp32 = name in norms
            if getattr(p, "sequence_parallel", False):
                stacked.sequence_parallel = True
            self.register_parameter(_stacked_name(name), stacked)
        # the template holds the layer's structure; functional_call swaps
        # in the stacks' slices, so its own tensors need no memory
        template.to("meta")
        object.__setattr__(self, "_template", template)
        self._pp_cut = False
        self._pp_group, self._stages, self._stage = None, 1, 0

    def train(self, mode=True):
        # the template is no submodule: its dropouts follow the model's mode
        super().train(mode)
        self._template.train(mode)
        return self

    # -- the cuts ------------------------------------------------------------ #

    def _mp_check(self, n):
        self._template.self_attn._mp_check(n)

    def _mp_shard(self, pg, rank, n):
        shard_model(self._template, pg)
        tparams = dict(self._template.named_parameters())
        for name in self._param_names:
            part = getattr(tparams[name], "mp_part", None)
            if part is not None:
                _cut(getattr(self, _stacked_name(name)), part[0] + 1, rank, n)
        self.mp_group = pg

    def _pp_shard(self, pg):
        """Keep this rank's stage rows of every stack (over the process
        group pg; None keeps every layer, one stage). Cut once."""
        if self._pp_cut:
            if pg is not self._pp_group:
                raise RuntimeError("the model is cut over another pp group "
                                   "already")
            return
        S = 1 if pg is None else torch.distributed.get_world_size(pg)
        s = 0 if pg is None else torch.distributed.get_rank(pg)
        V, L = self.vpp_degree, self.config.num_layers
        if L % (S * V):
            raise ValueError(f"num_layers {L} not divisible by pp*vpp "
                             f"{S * V}")
        with torch.no_grad():
            for name in self._param_names:
                p = getattr(self, _stacked_name(name))
                p.data = stage_rows(p.data, S, s, V).contiguous()
                p.pp_part = (S, s, V)
        self._pp_cut = True
        self._pp_group, self._stages, self._stage = pg, S, s

    def _group(self):
        """The pp group the schedules run over: the one the model was cut
        over, else the global mesh's (the model is cut over it now)."""
        if not self._pp_cut:
            mesh = _env.get_global_mesh()
            self._pp_shard(None if mesh is None
                           else _env.mesh_group(mesh, "pp"))
        return self._pp_group

    def num_stages(self):
        self._group()
        return self._stages

    # -- the stages ----------------------------------------------------------- #

    def _stacks(self, v):
        """Chunk v's layers: one {template name: slice} per layer."""
        lps = self.config.num_layers // (self._stages * self.vpp_degree)
        rows = {n: getattr(self, _stacked_name(n)).narrow(0, v * lps, lps)
                .unbind(0) for n in self._param_names}
        return [{n: rows[n][j] for n in self._param_names}
                for j in range(lps)]

    def _layer(self, params, h, pos):
        return torch.func.functional_call(self._template, params, (h, pos))

    def _body(self, v, x, pos, recompute_layers):
        """Virtual stage v * S + s: the embedding first on the first one,
        then its layers."""
        h = _embed(self, x, pos) if v == 0 and self._stage == 0 else x
        for params in self._stacks(v):
            if recompute_layers:
                h = recompute(self._layer, params, h, pos)
            else:
                h = self._layer(params, h, pos)
        return h

    def _tail(self, h):
        h = self.final_norm(h)
        if self.config.sequence_parallel and self.mp_group is not None:
            h = GatherOp.apply(h, 1, self.mp_group)
        return _lm_logits(self.config, h, self.embed_tokens,
                          getattr(self, "lm_head", None))

    def _positions(self, input_ids, position_ids):
        B, S = input_ids.shape[0], input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device)[None] \
                .expand(B, S)
        return microbatch(position_ids, self.num_microbatches)

    def forward(self, input_ids, position_ids=None, labels=None,
                criterion=None, more_labels=()):
        """The logits [B, S, vocab (its mp part)] on every rank, through
        GPipe or VPP; with a `criterion` (from `forward_loss`) the 1F1B
        loss instead."""
        group = self._group()
        pos = self._positions(input_ids, position_ids)
        ids = microbatch(input_ids, self.num_microbatches)
        if criterion is not None:
            return self._loss_1f1b(group, ids, pos, labels, criterion,
                                   more_labels)
        V, S = self.vpp_degree, self._stages
        layers = self.config.use_recompute and self.training and \
            torch.is_grad_enabled()

        def chunk(v, x, m):
            h = self._body(v, x, pos[m], layers)
            if v == V - 1 and self._stage == S - 1:
                h = self._tail(h)
            return h

        if self.pp_schedule == "vpp":
            out = pipeline_interleaved(chunk, ids, group=group,
                                       num_chunks=V, remat=False)
        else:
            out = pipeline_spmd(lambda x, m: chunk(0, x, m), ids,
                                group=group, remat=False)
        return unmicrobatch(out)

    def forward_loss(self, input_ids, labels, criterion, *more_labels):
        """The 1F1B loss (see the module docstring); with another
        pp_schedule, `criterion(forward(input_ids), labels, ...)`. Calls the
        module, so its forward hooks run around the schedule."""
        if self.pp_schedule != "1f1b":
            return criterion(self(input_ids), labels, *more_labels)
        return self(input_ids, labels=labels, criterion=criterion,
                    more_labels=more_labels)

    def _loss_1f1b(self, group, ids, pos, labels, criterion, more_labels):
        M = self.num_microbatches
        lab = [microbatch(t, M) for t in (labels, *more_labels)]

        def loss_fn(h, m):
            return criterion(self._tail(h), *[t[m] for t in lab])

        return pipeline_1f1b(lambda x, m: self._body(0, x, pos[m], False),
                             loss_fn, ids, group=group)


# ----------------------------------------------------------------------- #
# state-dict interop with the layered GPTForCausalLM
# ----------------------------------------------------------------------- #


def _stack(vals):
    if all(isinstance(v, torch.Tensor) for v in vals):
        return torch.stack([v.detach() for v in vals])
    return np.stack([np.asarray(v) for v in vals])


def stack_layered_state_dict(layered: dict, num_layers: int) -> dict:
    """A GPTForCausalLM state (gpt.layers.<i>.<name> keys; torch tensors or
    numpy arrays) in the pipe's layout: stack__<name> [L, ...] keys and the
    shared tables, norm and head under their pipe names."""
    out, per_layer = {}, {}
    for k, v in layered.items():
        if k.startswith("gpt.layers."):
            idx, pname = k[len("gpt.layers."):].split(".", 1)
            per_layer.setdefault(pname, [None] * num_layers)[int(idx)] = v
        elif k.startswith("gpt."):
            out[k[len("gpt."):]] = v
        else:
            out[k] = v
    for pname, vals in per_layer.items():
        if any(v is None for v in vals):
            raise ValueError(f"missing layers for {pname}")
        out[_stacked_name(pname)] = _stack(vals)
    return out


def unstack_to_layered_state_dict(pipe_sd: dict, num_layers: int) -> dict:
    """Inverse of stack_layered_state_dict."""
    out = {}
    for k, v in pipe_sd.items():
        if k.startswith("stack__"):
            pname = k[len("stack__"):].replace("__", ".")
            for i in range(num_layers):
                out[f"gpt.layers.{i}.{pname}"] = v[i]
        else:
            out["gpt." + k if not k.startswith("lm_head") else k] = v
    return out
