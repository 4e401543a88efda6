"""Serving engines: batched single-tenant and multi-tenant decode (port of
``repro.serve.engine``).

A tenant's fine-tune is a (base_seed, coords) payload of kilobytes;
:class:`MultiTenantEngine` turns those into per-slot personalized
parameters on admission, regenerating each adapter's basis in the kernel
through the fused multi-adapter apply (``serve.apply``), so B tenants
cost ONE extra launch and zero resident dense deltas for cache misses.
EOS-aware early stop and continuous batching (``serve.scheduler``)
retire finished requests at once, so they stop using their slot.

Both engines run where their parameters lie: on the card unless the
caller built them on the CPU.  Sampling at temperature > 0 draws from a
``torch.Generator`` seeded with the request's ``seed``: it is
deterministic, but its tokens are not those of the reference's
``jax.random.categorical``.  Greedy tokens (temperature <= 0) are the
argmax of the logits in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import projector
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.registry import Model
from repro_torch.serve import apply as serve_apply
from repro_torch.serve.adapters import AdapterCache, AdapterRegistry
from repro_torch.serve.scheduler import Scheduler


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int64: greedy at temperature <= 0, else a
    categorical draw at the given temperature (Gumbel-max with uniforms
    from ``generator``, on the logits' device).  EVERY emitted token --
    the first one out of prefill included -- goes through this one
    path."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1, keepdim=True)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    scaled = logits.to(torch.float32) / max(float(temperature), 1e-4)
    return torch.argmax(scaled + gumbel, dim=-1, keepdim=True)


def _check_room(prompt_len: int, max_new_tokens: int, max_len: int) -> None:
    # the last token is sampled, never fed back, so it needs no cache row
    if prompt_len + max_new_tokens - 1 > max_len:
        raise ValueError(
            f"prompt of {prompt_len} tokens + {max_new_tokens} new tokens "
            f"does not fit a cache of max_len {max_len}")


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


class Engine:
    """One set of parameters, batched prompts.

    The parameters are cast to the compute dtype once, here; the
    reference casts them at every prefill and decode call, and the cast
    is deterministic, so the values are the same."""

    def __init__(self, model: Model, params: dict, max_len: int = 2048):
        self.model = model
        self.params = params
        self.max_len = max_len
        self._cparams = L.cast_for_compute(
            params, L.dtype_of(model.cfg.compute_dtype))
        self.device = next(iter(params.values())).device

    def generate(self, prompts, n_tokens: int, *, temperature: float = 0.0,
                 seed: int = 0, eos_id: int | None = None,
                 pad_id: int = 0, extra_embeds=None) -> torch.Tensor:
        """prompts: (B, S) integer -> (B, n_tokens) int32 continuations.
        ``extra_embeds``: (B, P, D) embeddings prefilled before the prompt
        (the VLM's patches), or None.

        The first token is sampled from the prefill logits through the
        same temperature path as every later token.  With ``eos_id`` set,
        rows that emit EOS keep it, are right-padded with ``pad_id`` from
        there on, and once every row has finished the decode loop stops
        early."""
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.from_numpy(np.asarray(prompts))
        prompts = prompts.to(self.device)
        n_extra = 0
        if extra_embeds is not None:
            extra_embeds = extra_embeds.to(self.device)
            n_extra = extra_embeds.shape[1]
        _check_room(n_extra + prompts.shape[1], n_tokens, self.max_len)
        cfg = self.model.cfg
        logits, cache = transformer.prefill(cfg, self._cparams, prompts,
                                            self.max_len,
                                            extra_embeds=extra_embeds)
        gen = _generator(self.device, seed)
        token = sample_token(logits[:, -1, :], gen, temperature)
        out = [token]
        done = (token[:, 0] == eos_id) if eos_id is not None else None
        for _ in range(n_tokens - 1):
            if done is not None and bool(done.all()):
                break
            logits, cache = self.model.decode_step(self._cparams, cache,
                                                   token)
            token = sample_token(logits[:, -1, :], gen, temperature)
            if done is not None:
                token = torch.where(done[:, None], pad_id, token)
                done = done | (token[:, 0] == eos_id)
            out.append(token)
        res = torch.cat(out, dim=1)
        if res.shape[1] < n_tokens:
            res = torch.nn.functional.pad(res, (0, n_tokens - res.shape[1]),
                                          value=pad_id)
        return res.to(torch.int32)


class MultiTenantEngine:
    """Continuous batching over ``n_slots`` decode slots, each slot
    carrying its tenant's PERSONALIZED parameters.

    Admission path (per tick, see :meth:`step`):

    1. the scheduler fills free slots FIFO;
    2. every admitted tenant's packed parameter row is produced -- cache
       hits by delta add, all misses together by ONE fused
       regenerate-and-apply launch (``serve.apply.personalize``);
    3. each new row is unpacked into its slot's parameter map: views of
       the packed row, cast once to the compute dtype (a bf16 copy under
       bf16 compute -- the same deterministic cast the reference makes at
       every tick, made once here);
    4. each admitted prompt is prefilled with its slot's parameters and
       its first token sampled through the shared temperature path.

    Decode is one tick over every decoding slot.  The reference's vmap
    over slots is written out as a loop over the slot axis: each slot
    has its own parameters, its own B = 1 cache (K/V, recurrent states,
    the hybrid's shared K/V: whatever the family keeps) and its own cache
    length, and steps through the B = 1 ``decode_step``, so a
    slot's tokens are bit-identical to :class:`Engine`'s on the same
    parameters and prompt.  Retirement (EOS or token budget) frees the
    slot for the next queued request on the following tick.
    """

    def __init__(self, model: Model, base_params: dict, plan, *,
                 registry: AdapterRegistry,
                 delta_cache: AdapterCache | None = None,
                 n_slots: int = 4, max_len: int = 256,
                 backend: str = "cuda", prng="threefry",
                 pin_on_miss: bool = True, layout=None):
        self.model = model
        self.plan = plan
        self.layout = layout if layout is not None else plan.packed()
        self.registry = registry
        self.delta_cache = delta_cache
        self.backend = backend
        self.prng = prng
        self.pin_on_miss = pin_on_miss
        self.n_slots = n_slots
        self.max_len = max_len
        self.scheduler = Scheduler(n_slots)
        self.base_params = base_params
        self.theta = projector.pack_tree(base_params, plan, self.layout)
        self.device = self.theta.device
        self.stats = {"decode_steps": 0, "prefills": 0,
                      "fused_launches": 0, "params_rebuilds": 0}
        base = self._params_of(self.theta)
        self._slot_thetas = [self.theta] * n_slots
        self.slot_params = [base] * n_slots
        self._base_slot_params = base
        self.slot_cache: list[dict | None] = [None] * n_slots
        self._slot_gens: list[torch.Generator | None] = [None] * n_slots
        self._slot_temps = [0.0] * n_slots
        self._last_tokens: list[torch.Tensor | None] = [None] * n_slots

    def _params_of(self, row: torch.Tensor) -> dict:
        """A packed row -> the slot's parameter map in the compute dtype."""
        return L.cast_for_compute(
            projector.unpack_tree(row, self.plan, self.layout,
                                  self.base_params),
            L.dtype_of(self.model.cfg.compute_dtype))

    # -- request API --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               adapter_id: str | None = None, temperature: float = 0.0,
               seed: int = 0, eos_id: int | None = None) -> int:
        if adapter_id is not None:
            self.registry.get(adapter_id)  # fail fast on unknown tenant
        _check_room(int(np.asarray(prompt).size), max_new_tokens,
                    self.max_len)
        return self.scheduler.submit(
            prompt, max_new_tokens, adapter_id=adapter_id,
            temperature=temperature, seed=seed, eos_id=eos_id)

    def run(self) -> dict[int, np.ndarray]:
        """Drive ticks until every submitted request has retired; returns
        rid -> generated tokens (EOS kept, nothing after it)."""
        while not self.scheduler.all_done():
            self.step()
        return self.scheduler.results()

    def step(self) -> None:
        """One engine tick: admit + prefill, then one decode tick."""
        self._admit_and_prefill()
        self._decode_tick()

    def cache_stats(self) -> dict:
        return (self.delta_cache.stats() if self.delta_cache is not None
                else {})

    # -- internals ----------------------------------------------------

    def _personalize_slots(self, admitted) -> None:
        rows: dict[int, torch.Tensor] = {}
        need: list[tuple[int, object]] = []
        for slot, req in admitted:
            if req.adapter_id is None:
                rows[slot] = self.theta
            else:
                need.append((slot, self.registry.get(req.adapter_id)))
        if need:
            uniq: dict[str, object] = {}
            for _, spec in need:
                uniq.setdefault(spec.adapter_id, spec)
            specs = list(uniq.values())
            buf, info = serve_apply.personalize(
                self.theta, specs, self.plan, self.layout,
                cache=self.delta_cache, backend=self.backend,
                prng=self.prng, pin_misses=self.pin_on_miss)
            self.stats["fused_launches"] += info["fused_launches"]
            idx = {aid: i for i, aid in enumerate(uniq)}
            for slot, spec in need:
                rows[slot] = buf[idx[spec.adapter_id]]
        for slot, row in rows.items():
            self._slot_thetas[slot] = row
            self.slot_params[slot] = (self._base_slot_params
                                      if row is self.theta
                                      else self._params_of(row))
        if rows:
            self.stats["params_rebuilds"] += 1

    def _admit_and_prefill(self) -> None:
        admitted = self.scheduler.admit()
        if not admitted:
            return
        self._personalize_slots(admitted)
        cfg = self.model.cfg
        for slot, req in admitted:
            prompt = torch.from_numpy(req.prompt).to(self.device)[None, :]
            logits, cache = transformer.prefill(
                cfg, self.slot_params[slot], prompt, self.max_len)
            self.slot_cache[slot] = cache
            self.stats["prefills"] += 1
            gen = _generator(self.device, req.seed)
            tok = sample_token(logits[:, -1, :], gen, req.temperature)
            self._slot_gens[slot] = gen
            self._slot_temps[slot] = req.temperature
            self._last_tokens[slot] = tok
            self.scheduler.mark_prefilled(slot)
            if self.scheduler.record_token(slot, int(tok[0, 0])):
                self.scheduler.retire(slot)

    def _decode_tick(self) -> None:
        active = self.scheduler.active()
        if not active:
            return
        for slot, _req in active:
            logits, self.slot_cache[slot] = self.model.decode_step(
                self.slot_params[slot], self.slot_cache[slot],
                self._last_tokens[slot])
            self._last_tokens[slot] = sample_token(
                logits[:, -1, :], self._slot_gens[slot],
                self._slot_temps[slot])
        self.stats["decode_steps"] += 1
        toks = torch.cat([self._last_tokens[s] for s, _ in active]).cpu()
        for (slot, _req), tok in zip(active, toks[:, 0].tolist()):
            if self.scheduler.record_token(slot, tok):
                self.scheduler.retire(slot)
