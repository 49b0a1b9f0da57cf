"""Serving engine: continuous batching over the paged KV pool —
counterpart of `paddle_tpu/serving/engine.py`.

Four step shapes serve every request mix, as in the JAX engine:

  * chunked prefill — B=1, T=prefill_chunk: one prompt chunk streams
    through the model, its K/V landing in the sequence's pool pages;
  * batched decode  — B=max_batch_size, T=1: every RUNNING request
    advances one token in one dispatch;
  * batched verify  — B=max_batch_size, T=spec_k+1 (speculative
    decoding, spec_k > 0): each greedy request carries the draft tokens
    an n-gram proposer found in its own history as extra ragged query
    rows; the argmax at every position comes back in the one fetch, the
    longest agreeing draft prefix is accepted plus the next token, and
    pages grown for rejected drafts are trimmed back. Greedy output is
    the one-token path's;
  * fused decode    — fused_k > 1: K iterations of the [B, 1] step with
    the carry (last token, seq_len, done mask, emitted count) on the
    card, eos and budget checked there, and ONE fetch of the sampled ids
    for the window. Taken when the scheduler is quiescent, no drafts
    ride this step and every row's window of pages can be reserved;
    otherwise the [B, 1] step runs. Tokens equal serial decode's.

Every step runs `GPTModel.forward_paged` (ragged paged attention + the
in-place K/V scatter) eagerly under `torch.inference_mode()` with the
model in eval mode, picks the next token ON DEVICE from fp32 logits
(the LM-head product upcasts the tied weight once a dispatch, as the
JAX product's `preferred_element_type`), and fetches only the chosen ids
through `_host_fetch` — one host round-trip per dispatch or window. Idle
decode slots ride along with q_len=0: their K/V writes land in the
pool's sink page and their outputs are ignored.

Sampling (`top_k > 0`): the logits are divided by max(temperature,
1e-6), every logit below the k-th largest (after a full sort, so ties
with it stay in) is masked to -1e30, and the token is the argmax of the
masked logits plus Gumbel noise, which is how `jax.random.categorical`
samples. The noise of (row, vocab index) is a counter-based hash in
integer torch ops of (seed, the request's engine-local ordinal, the
absolute position of the token drawn, the vocab index), turned into a
uniform on (0, 1): the same bits on the CPU and on the card, whatever
the batch or the dispatch. So fused, serial, verify and preempt/resume
runs draw identical tokens. JAX folds a threefry key with the same
inputs; the two packages' sampled tokens differ, their greedy tokens do
not. `top_k <= 0` is greedy, temperature ignored.

`kv_dtype='int8'`: the pool stores int8 K/V and one fp32 abs-max scale
per (slot, head); rows are quantized as they are written and the paged
attention kernel dequantizes inside (`paged_attention_int8`).
`weight_dtype='int8'`: every 2-D floating weight whose name lacks
`embed` (the four matmul weights of each layer; the tied LM head stays
full precision) is kept as int8 codes with per-out-channel fp32 scales
(`quantization.quantize_to_int8`), and each is dequantized to the
model's dtype just before its module runs and dropped after it, inside
the engine's forward. The model's own full-precision weights stay where
they are, as in the JAX engine.

Prefix caching rides in the pool (kv_pool.py): prompts sharing a prefix
map the same physical pages and skip the prefill compute for them.
Scheduling (admission with a free-page budget and a bounded head-of-line
bypass, preempt-youngest under pool pressure) follows the JAX engine
decision for decision, so the two engines emit identical greedy tokens
on the same weights.

The engine runs on `device`: the card unless the caller passes
device='cpu'; without a card and without device='cpu' it raises.

Not ported yet: tenancy and the degradation ladder, disaggregation, the
host-RAM tier, request tracing and the stalled-request watchdog. Their
knobs are accepted at the reference's defaults (trace only as False), so
a config written for the reference builds; a value that would turn one
on or tune it raises NotImplementedError. Also not ported: metrics
publication and the serving ledger.
"""
import contextlib
import math
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..quantization import dequantize_weight, quantize_to_int8
from .kv_pool import KVPagePool, PoolExhausted
from .scheduler import Request, RequestState, Scheduler

# Every JAX ServingConfig knob the port does not serve
# (paddle_tpu/serving/engine.py:181-191), with the values it accepts: the
# reference's default, or the value that turns the feature off. Any other
# value would turn on (or tune) an unported feature and raises
# NotImplementedError. `trace` is the exception to "accepts the
# default": the reference journals requests by default (trace=True), the
# port has no journal yet, so only trace=False is accepted.
_UNSERVED = {
    'trace': (False,), 'trace_events_per_request': (512,),
    'trace_requests': (512,), 'timeline_capacity': (2048,),
    'request_deadline_s': (None,), 'deadline_action': ('report',),
    'report_dir': (None,), 'clock': (None,), 'disaggregate': (False,),
    'prefill_slots': (2,), 'stream_chunk_pages': (0,), 'tenants': (None,),
    'degrade': (None, False), 'degrade_window': (8,),
    'degrade_up': ((0.85, 0.92, 0.97),),
    'degrade_down': ((0.60, 0.70, 0.80),), 'degrade_hold': (4,),
    'host_tier_pages': (0,), 'spill_watermark': (0.92,),
    'spill_chunk_pages': (0,), 'spill_window': (2,),
}


def _equal(value, ok):
    try:
        return value is ok or bool(value == ok)
    except (TypeError, ValueError):     # e.g. an array of several values
        return False


def _host_fetch(x):
    """Every fetch of chosen token ids from the device funnels through
    here, so tests can count the engine's host syncs (engine.py:64 in
    the JAX package)."""
    return x.cpu().numpy()


class ServingConfig:
    """Knobs (docs/serving.md#tuning in the JAX package):

    page_size          tokens per KV page
    max_batch_size     decode slots = max concurrent requests
    num_pages          pool capacity; default fits every slot at
                       max_pages_per_seq (no preemption pressure)
    max_pages_per_seq  page-table width; default covers max_seq_len
    prefill_chunk      prompt tokens per prefill dispatch
    kv_dtype           pool dtype (default: the model's parameter
                       dtype); 'int8' stores int8 pages with one fp32
                       abs-max scale per (slot, head)
    weight_dtype       None or 'int8': weight-only int8 matmul weights,
                       dequantized at use
    prefix_cache       copy-on-write prefix sharing over the pool
    spec_k             speculative draft length (0 = off)
    spec_ngram         the proposer's trailing n-gram length
    fused_k            decode iterations fused into one window with one
                       host fetch (default $PTPU_SERVE_FUSED_K, else 1
                       = off)
    seed               the sampling draw's seed
    """

    def __init__(self, page_size=16, max_batch_size=4, num_pages=None,
                 max_pages_per_seq=None, prefill_chunk=32, kv_dtype=None,
                 weight_dtype=None, prefix_cache=True, spec_k=0,
                 spec_ngram=2, fused_k=None, seed=0, **unserved):
        for knob, value in unserved.items():
            if knob not in _UNSERVED:
                raise TypeError(f'ServingConfig: unknown knob {knob!r}')
            if not any(_equal(value, ok) for ok in _UNSERVED[knob]):
                raise NotImplementedError(
                    f'ServingConfig({knob}={value!r}) is not ported yet')
        if page_size <= 0 or max_batch_size <= 0 or prefill_chunk <= 0:
            raise ValueError("page_size, max_batch_size and "
                             "prefill_chunk must be positive")
        if spec_k < 0 or spec_ngram < 1:
            raise ValueError("spec_k must be >= 0 and spec_ngram >= 1")
        if fused_k is None:
            fused_k = int(os.environ.get('PTPU_SERVE_FUSED_K', '1'))
        if int(fused_k) < 1:
            raise ValueError("fused_k must be >= 1 (1 = per-token "
                             "decode, k > 1 = fused k-step windows)")
        if weight_dtype is not None and \
                str(weight_dtype).replace('torch.', '') != 'int8':
            raise ValueError("weight_dtype must be None or 'int8', got "
                             f"{weight_dtype!r}")
        self.page_size = int(page_size)
        self.max_batch_size = int(max_batch_size)
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = int(prefill_chunk)
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.prefix_cache = bool(prefix_cache)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.fused_k = int(fused_k)
        self.seed = int(seed)


class ServingEngine:
    """Continuous-batching inference over a GPTForCausalLM on `device`."""

    # followers a budget-blocked queue head tolerates being admitted
    # past it before the admission sweep reverts to blocking at the head
    HOL_BYPASS_LIMIT = 8

    def __init__(self, model, config=None, device=None, **cfg_kw):
        if config is None:
            config = ServingConfig(**cfg_kw)
        elif cfg_kw:
            raise ValueError("pass either config or knobs, not both")
        self.device = resolve_device(device)
        param = model.gpt.embeddings.word_embeddings.weight
        if param.device.type != self.device.type or (
                self.device.index is not None
                and param.device.index != self.device.index):
            raise ValueError(
                f'the model lives on {param.device}, the engine on '
                f'{self.device}: move the model (model.to(device)) first')
        self.model = model
        self.config = config
        mcfg = model.config
        ps = config.page_size
        self.max_pages_per_seq = int(
            config.max_pages_per_seq or math.ceil(mcfg.max_seq_len / ps))
        num_pages = int(config.num_pages
                        or config.max_batch_size * self.max_pages_per_seq)
        attn0 = model.gpt.layers[0].attn
        self.pool = KVPagePool(
            num_pages, ps, num_layers=mcfg.num_layers,
            num_heads=attn0.local_heads, head_dim=attn0.head_dim,
            dtype=config.kv_dtype or param.dtype,
            prefix_cache=config.prefix_cache)
        self.pool.materialize(param.device)
        self.scheduler = Scheduler(config.max_batch_size)
        # weight-only int8 (engine.py:368-390): {param name: (module,
        # attribute, codes, scales)}, quantized once here
        self._qweights = {}
        if config.weight_dtype is not None:
            for name, p in model.named_parameters():
                if p.ndim != 2 or 'embed' in name \
                        or not p.is_floating_point():
                    continue
                mod_name, _, attr = name.rpartition('.')
                q, s = quantize_to_int8(p, quant_axis=1)
                self._qweights[name] = (model.get_submodule(mod_name),
                                        attr, q, s)
        self._next_sample_ord = 0
        self.reset_stats()
        self._submitted = 0
        self._completed = 0

    # -- request intake ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
               temperature=1.0, top_k=0):
        """Queue one request: greedy at top_k <= 0 (temperature
        ignored), else sampled from the temperature-scaled top-k set."""
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, temperature=temperature,
                      top_k=top_k)
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_pages_per_seq * self.pool.page_size:
            raise ValueError(
                f"request needs {total} tokens; page table holds "
                f"{self.max_pages_per_seq} pages of {self.pool.page_size}")
        if self.pool.pages_for(total) > self.pool.num_pages:
            # admission's page budget would skip it forever
            raise PoolExhausted(
                f"KV pool ({self.pool.num_pages} pages x "
                f"{self.pool.page_size}) cannot hold one request of "
                f"{total} tokens — raise num_pages")
        if total > self.model.config.max_seq_len:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new_tokens"
                f"({req.max_new_tokens}) exceeds max_seq_len"
                f"({self.model.config.max_seq_len})")
        # engine-local ordinal in submission order: identically seeded
        # engines fed the same prompts draw identical tokens
        req.sample_ord = self._next_sample_ord
        self._next_sample_ord += 1
        self.scheduler.submit(req)
        self._submitted += 1
        return req

    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=1.0, top_k=0, max_steps=None):
        """Submit every prompt, drive step() until drained, return the
        per-prompt token lists (prompt + generated) in submission
        order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id,
                            temperature=temperature, top_k=top_k)
                for p in prompts]
        guard = max_steps or 16 * (max_new_tokens + 4) * max(
            1, math.ceil(len(reqs) / self.config.max_batch_size))
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if steps > guard:
                raise RuntimeError(
                    f"serving loop did not drain in {guard} steps")
        return [r.output_ids() for r in reqs]

    # -- engine iteration ----------------------------------------------------
    def step(self):
        """One scheduler iteration: admit waiting requests, advance one
        prefill chunk per prefilling request, then one batched decode
        step (or fused window) for the running set."""
        self._admit()
        for req in [r for r in self.scheduler.slots
                    if r is not None and r.state == RequestState.PREFILL]:
            self._prefill_chunk_step(req)
        if any(r is not None and r.state == RequestState.RUNNING
               for r in self.scheduler.slots):
            self._decode_step()

    def _admit(self):
        """Admit waiting requests one at a time against a free-page
        budget: each admission reserves its FIRST chunk's pages, net of
        pages a live sibling already maps (prefix hits). A head whose
        first chunk exceeds this sweep's budget is skipped, keeping its
        queue position, and admissible followers behind it go in — at
        most HOL_BYPASS_LIMIT of them past one head, after which the
        sweep blocks at the head so freed pages accumulate for it
        (engine.py:913 in the JAX package)."""
        sched = self.scheduler
        budget = self.pool.free_pages
        n_admitted = 0
        n_bypassed = 0
        blocked_head = None
        skipped_before = False
        for req in sched.admission_order():
            if None not in sched.slots:
                break
            cached, live, _resurrect = self.pool.peek_prefix(
                req.tokens, limit=len(req.tokens) - 1)
            need = max(self.pool.pages_for(
                min(len(req.tokens),
                    cached + self.config.prefill_chunk)) - live, 0)
            if budget < need:
                if not skipped_before:
                    if req.admit_bypasses >= self.HOL_BYPASS_LIMIT:
                        break       # starvation bound: block at the head
                    blocked_head = req
                skipped_before = True
                continue
            if sched.admit_request(req) is None:
                skipped_before = True
                continue
            budget -= need
            n_admitted += 1
            if blocked_head is not None:
                n_bypassed += 1
        if blocked_head is not None:
            blocked_head.admit_bypasses += n_bypassed
        return n_admitted

    def _ensure_or_preempt(self, req, n_tokens):
        """Grow req's pages, preempting the youngest other request until
        the allocation fits. A victim whose pages are all shared frees
        nothing, so the loop moves on to the next victim."""
        sched = self.scheduler
        while True:
            try:
                self.pool.ensure_capacity(req.id, n_tokens)
                return
            except PoolExhausted:
                victim = sched.preempt_victim(exclude=req)
                if victim is None:
                    raise PoolExhausted(
                        f"KV pool ({self.pool.num_pages} pages x "
                        f"{self.pool.page_size}) cannot hold one request "
                        f"of {n_tokens} tokens — raise num_pages")
                self.pool.release(victim.id)
                sched.preempt(victim)

    def _page_row(self, req):
        row = self.pool.page_table(req.id)
        return row + [0] * (self.max_pages_per_seq - len(row))

    # -- device work ---------------------------------------------------------
    @contextlib.contextmanager
    def _serving(self):
        """The model in eval mode under inference_mode, with int8
        weights dequantized one module at a time: each weight is
        replaced by its dequantized copy just before its module runs
        and put back just after, so no full-precision copy of the model
        is ever built."""
        model = self.model
        was_training = model.training
        model.eval()
        handles, originals = [], []
        for mod, attr, q, s in self._qweights.values():
            param = mod._parameters[attr]
            originals.append((mod, attr, param))
            handles.append(mod.register_forward_pre_hook(
                _dequantize_hook(attr, q, s, param.dtype)))
            handles.append(mod.register_forward_hook(
                _restore_hook(attr, param)))
        try:
            with torch.inference_mode():
                yield
        finally:
            for h in handles:
                h.remove()
            for mod, attr, param in originals:
                mod._parameters[attr] = param
            if was_training:
                model.train()

    def _head(self):
        """The tied LM head in fp32, upcast once per dispatch: the
        logits are fp32 products of the activations and the embedding,
        as the JAX step's `preferred_element_type` gives them."""
        return self.model.gpt.embeddings.word_embeddings.weight.float()

    def _hidden(self, tokens, page_tables, seq_lens, q_lens):
        """One paged forward from host numpy int32 inputs: tokens [B, T],
        page_tables [B, max_pages_per_seq], seq_lens and q_lens [B].
        Returns hidden [B, T, H] on the device (call under _serving)."""
        T = tokens.shape[1]
        max_pos = self.model.config.max_seq_len - 1
        pos = np.clip(seq_lens[:, None] - q_lens[:, None]
                      + np.arange(T, dtype=np.int32)[None, :], 0, max_pos)
        h, _ = self.model.gpt.forward_paged(
            torch.from_numpy(tokens), torch.from_numpy(pos), self.pool.kv,
            torch.from_numpy(page_tables), torch.from_numpy(seq_lens),
            torch.from_numpy(q_lens))
        return h

    def _logits(self, tokens, page_tables, seq_lens, q_lens):
        """fp32 logits [B, V] of each row's last new token (call under
        _serving)."""
        h = self._hidden(tokens, page_tables, seq_lens, q_lens)
        B, T = tokens.shape
        last = torch.from_numpy(np.clip(q_lens - 1, 0, T - 1)).to(h.device)
        h_last = h[torch.arange(B, device=h.device), last]
        return torch.matmul(h_last.float(), self._head().t())

    def _choose(self, logits, ords, positions, temps, top_ks):
        """Next token per row of fp32 logits [B, V], on the device:
        greedy unless a row samples. The row metadata is host numpy."""
        if not (top_ks > 0).any():
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        return _device_sample(
            logits, self.config.seed,
            torch.from_numpy(ords.astype(np.int64)).to(dev),
            torch.from_numpy(positions.astype(np.int64)).to(dev),
            torch.from_numpy(temps.astype(np.float32)).to(dev),
            torch.from_numpy(top_ks.astype(np.int64)).to(dev))

    def _step_tokens(self, tokens, page_tables, seq_lens, q_lens, ords,
                     temps, top_ks, verify=False):
        """One dispatch, fetched: [B] next tokens; with `verify`, [B, T]
        greedy argmax at every query position (the drafts' verdicts),
        plus a column T holding the sampled token of rows that sample
        (engine.py:1238-1263)."""
        with self._serving():
            if verify:
                h = self._hidden(tokens, page_tables, seq_lens, q_lens)
                logits = torch.matmul(h.float(), self._head().t())
                nxt = torch.argmax(logits, dim=-1)              # [B, T]
                if (top_ks > 0).any():
                    B, T = tokens.shape
                    last = torch.from_numpy(np.clip(q_lens - 1, 0, T - 1))
                    rows = torch.arange(B)
                    samp = self._choose(
                        logits[rows.to(h.device), last.to(h.device)],
                        ords, seq_lens, temps, top_ks)
                    nxt = torch.cat([nxt, samp[:, None]], 1)
            else:
                nxt = self._choose(
                    self._logits(tokens, page_tables, seq_lens, q_lens),
                    ords, seq_lens, temps, top_ks)
        return _host_fetch(nxt)

    def prompt_logits(self, prompt_ids):
        """fp32 logits of the token after `prompt_ids`, computed by the
        engine's own prefill steps on scratch pages that are released
        afterwards (nothing is registered in the prefix index). Returns
        a CPU tensor [V]."""
        toks = [int(t) for t in prompt_ids]
        C = self.config.prefill_chunk
        seq = ('prompt_logits', id(toks))
        try:
            self.pool.ensure_capacity(seq, len(toks))
            row = self.pool.page_table(seq)
            row = np.asarray([row + [0] * (self.max_pages_per_seq
                                           - len(row))], np.int32)
            with self._serving():
                for start in range(0, len(toks), C):
                    n = min(C, len(toks) - start)
                    chunk = toks[start:start + n] + [0] * (C - n)
                    logits = self._logits(
                        np.asarray([chunk], np.int32), row,
                        np.asarray([start + n], np.int32),
                        np.asarray([n], np.int32))
                return logits[0].cpu()
        finally:
            self.pool.release(seq)

    def _prefill_chunk_step(self, req):
        C = self.config.prefill_chunk
        if req.state != RequestState.PREFILL:
            return 0        # preempted earlier in this same sweep
        toks = req.tokens
        if req.prefilled == 0 and self.pool.prefix_cache:
            # first chunk of a fresh admit (or a resume): map the longest
            # indexed prefix, capped one short of the context so the
            # step still computes the logits the first token needs
            cached = self.pool.match_and_map(req.id, toks,
                                             limit=len(toks) - 1)
            if cached:
                req.prefilled = cached
        start = req.prefilled
        n = min(C, len(toks) - start)
        self._ensure_or_preempt(req, start + n)
        chunk = toks[start:start + n] + [0] * (C - n)
        t0 = time.perf_counter()
        nxt = self._step_tokens(
            np.asarray([chunk], np.int32),
            np.asarray([self._page_row(req)], np.int32),
            np.asarray([start + n], np.int32), np.asarray([n], np.int32),
            np.asarray([_ord_of(req)]), np.asarray([req.temperature]),
            np.asarray([req.top_k]))
        self._prefill_time += time.perf_counter() - t0
        req.prefilled = start + n
        self._prefill_tokens += n
        self._prefill_chunks += 1
        # every prefilled token's K/V is resident: index the newly
        # completed full pages so siblings (and our own resume) share
        self.pool.register_prefix(req.id, toks, req.prefilled)
        if req.prefilled == len(toks):
            if req.max_new_tokens <= 0:
                self._retire(req)   # prefill-only request
                return n
            req.generated.append(int(nxt[0]))
            if req.first_token_time is None:
                req.first_token_time = time.perf_counter()
                self._ttfts_s.append(req.first_token_time - req.submit_time)
            if req.done:
                self._retire(req)
            else:
                req.state = RequestState.RUNNING
        return n

    def _decode_step(self):
        """One batched decode dispatch (engine.py:1666-1848). With
        spec_k > 0, greedy requests whose history yields an n-gram
        proposal carry up to spec_k drafts into the [B, spec_k+1] verify
        step; the longest agreeing draft prefix plus the next token is
        accepted, and pages grown for rejected drafts are handed back
        (their slots are rewritten in place before any step can read
        them: the seq_len mask hides them until then). With fused_k > 1
        and no drafts, a quiescent scheduler runs a fused window
        instead. Returns (rows, tokens emitted)."""
        sched = self.scheduler
        K = self.config.spec_k
        proposals = {}
        if K > 0:
            for req in sched.slots:
                if req is None or req.state != RequestState.RUNNING \
                        or req.top_k > 0:
                    continue        # spec verify is greedy-only
                budget = req.max_new_tokens - len(req.generated) - 1
                drafts = _ngram_propose(req.tokens, self.config.spec_ngram,
                                        min(K, budget))
                if drafts:
                    proposals[req.id] = drafts
        FK = self.config.fused_k
        if FK > 1 and not proposals and sched.quiescent():
            res = self._fused_decode_window(FK)
            if res is not None:
                return res
        # capacity first (may preempt); then snapshot the running set
        for req in list(sched.slots):
            if req is not None and req.state == RequestState.RUNNING:
                self._ensure_or_preempt(
                    req, req.context_len + len(proposals.get(req.id, ())))
        B = self.config.max_batch_size
        verify = any(req is not None and req.state == RequestState.RUNNING
                     and req.id in proposals for req in sched.slots)
        T = K + 1 if verify else 1
        tokens = np.zeros((B, T), np.int32)
        page_tables = np.zeros((B, self.max_pages_per_seq), np.int32)
        seq_lens = np.ones((B,), np.int32)
        q_lens = np.zeros((B,), np.int32)
        ords = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int64)
        active = []
        for i, req in enumerate(sched.slots):
            if req is None or req.state != RequestState.RUNNING:
                continue
            drafts = list(proposals.get(req.id, ())) if verify else []
            active.append((i, req, drafts))
            tokens[i, 0] = (req.generated[-1] if req.generated
                            else req.prompt[-1])
            tokens[i, 1:1 + len(drafts)] = drafts
            page_tables[i, :] = self._page_row(req)
            seq_lens[i] = req.context_len + len(drafts)
            q_lens[i] = 1 + len(drafts)
            ords[i] = _ord_of(req)
            temps[i] = req.temperature
            top_ks[i] = req.top_k
        if not active:
            return 0, 0
        t0 = time.perf_counter()
        nxt = self._step_tokens(tokens, page_tables, seq_lens, q_lens, ords,
                                temps, top_ks, verify=verify)
        self._decode_time += time.perf_counter() - t0
        self._decode_steps += 1
        self._occupancy_sum += len(active) / B
        self._util_sum += self.pool.utilization()
        emitted_total = 0
        for i, req, drafts in active:
            if not verify:
                appended = [int(nxt[i])]
            elif req.top_k > 0:
                appended = [int(nxt[i, T])]         # the sampled column
            else:
                g = nxt[i]
                m = 0
                while m < len(drafts) and int(g[m]) == drafts[m]:
                    m += 1
                appended = drafts[:m] + [int(g[m])]
                if drafts:
                    self._spec_proposed += len(drafts)
                    self._spec_accepted += m
                    self._spec_steps += 1
            # emit in order, stopping at eos or the budget exactly where
            # the one-token path would
            for tok in appended:
                req.generated.append(tok)
                emitted_total += 1
                if req.done:
                    break
            if drafts:
                # speculative rollback: hand back pages grown for
                # rejected drafts beyond the accepted context
                self.pool.trim(req.id, req.context_len)
            # K/V is resident for everything but the newest token
            self.pool.register_prefix(req.id, req.tokens,
                                      req.context_len - 1)
            if req.done:
                self._retire(req)
        self._decode_tokens += emitted_total
        return len(active), emitted_total

    # -- fused decode windows --------------------------------------------------
    def _fused_decode_window(self, K):
        """Up to K decode iterations on the card and ONE host fetch
        (engine.py:1431). Every row's whole window of pages is reserved
        up front (pool.try_reserve, all or nothing); the host replays
        the serial append-then-check loop on the fetched [B, K] ids, so
        eos and budget cuts land exactly where K serial steps stop, and
        the unused tail of each reservation is trimmed back. Returns
        (rows, tokens emitted), or None when a reservation fails and the
        [B, 1] step should run instead."""
        sched = self.scheduler
        B = self.config.max_batch_size
        rows = []
        for i, req in enumerate(sched.slots):
            if req is None or req.state != RequestState.RUNNING:
                continue
            w = min(K, req.max_new_tokens - len(req.generated))
            if not self.pool.try_reserve(req.id, req.context_len + w):
                # roll the earlier rows' fresh reservations back so the
                # serial step sees the pool it would have seen
                for _i, r, _w in rows:
                    self.pool.trim(r.id, r.context_len)
                return None
            rows.append((i, req, w))
        if not rows:
            return 0, 0
        meta = {'tokens': np.zeros((B,), np.int64),
                'page_tables': np.zeros((B, self.max_pages_per_seq),
                                        np.int32),
                'seq_lens': np.ones((B,), np.int32),
                'ords': np.zeros((B,), np.int64),
                'rems': np.zeros((B,), np.int32),
                'eos_ids': np.full((B,), -1, np.int64),
                'live': np.zeros((B,), bool),
                'temps': np.zeros((B,), np.float32),
                'top_ks': np.zeros((B,), np.int64)}
        for i, req, w in rows:
            meta['tokens'][i] = (req.generated[-1] if req.generated
                                 else req.prompt[-1])
            meta['page_tables'][i, :] = self._page_row(req)
            meta['seq_lens'][i] = req.context_len
            meta['ords'][i] = _ord_of(req)
            meta['rems'][i] = w
            if req.eos_token_id is not None:
                meta['eos_ids'][i] = req.eos_token_id
            meta['live'][i] = True
            meta['temps'][i] = req.temperature
            meta['top_ks'][i] = req.top_k
        t0 = time.perf_counter()
        with self._serving():
            ys = self._fused_steps(K, meta)
        nxt = _host_fetch(ys)               # ONE fetch for the window
        self._decode_time += time.perf_counter() - t0
        emitted_total = 0
        per_iter_rows = [0] * K
        accepted = {}
        for i, req, _w in rows:
            a = 0
            for j in range(K):
                if req.done:
                    break
                req.generated.append(int(nxt[i, j]))
                per_iter_rows[j] += 1
                a += 1
            accepted[i] = a
            emitted_total += a
        iters_run = max(accepted.values())
        util = self.pool.utilization()
        for j in range(iters_run):
            self._occupancy_sum += per_iter_rows[j] / B
            self._util_sum += util
        self._decode_steps += iters_run
        self._decode_tokens += emitted_total
        self._fused_windows += 1
        self._fused_iterations += iters_run
        self._fused_tokens += emitted_total
        for _i, req, _w in rows:
            # hand back the reserved-but-unused tail (early eos or a
            # budget cut), as the speculative rollback does
            self.pool.trim(req.id, req.context_len)
            self.pool.register_prefix(req.id, req.tokens,
                                      req.context_len - 1)
            if req.done:
                self._retire(req)
        return len(rows), emitted_total

    def _fused_steps(self, K, meta):
        """K iterations of the [B, 1] decode step with the carry on the
        card (engine.py:1320 `_build_fused_step`): each is exactly the
        serial step — same forward, positions and draw — and a row that
        hits eos or its budget turns done and rides the rest with q_len
        0, its K/V writes sent to the pool's sink page. Returns the
        [B, K] chosen ids on the device; nothing here waits for it."""
        dev = self.device
        B = meta['tokens'].shape[0]
        max_pos = self.model.config.max_seq_len - 1
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in meta.items()}
        tok = on_dev['tokens']
        seq = on_dev['seq_lens']
        done = ~on_dev['live']
        emitted = torch.zeros(B, dtype=torch.int32, device=dev)
        rems, eos_ids = on_dev['rems'], on_dev['eos_ids']
        sample = bool((meta['top_ks'] > 0).any())
        w = self._head()
        ys = []
        for _ in range(K):
            q = (~done).to(torch.int32)
            pos = (seq - q).clamp(0, max_pos)[:, None]
            h, _ = self.model.gpt.forward_paged(
                tok[:, None], pos, self.pool.kv, on_dev['page_tables'], seq, q)
            logits = torch.matmul(h[:, 0].float(), w.t())
            if sample:
                nxt = _device_sample(logits, self.config.seed,
                                     on_dev['ords'], seq.long(),
                                     on_dev['temps'], on_dev['top_ks'])
            else:
                nxt = torch.argmax(logits, dim=-1)
            # the emitted token counts before the eos/budget check
            # (append-then-check), as the serial path
            emitted = emitted + q
            done = done | ((eos_ids >= 0) & (nxt == eos_ids)) \
                | (emitted >= rems)
            tok = torch.where(q.bool(), nxt, tok)
            seq = seq + q
            ys.append(nxt)
        return torch.stack(ys, 1)

    def _retire(self, req):
        self.pool.release(req.id)
        self.scheduler.retire(req)
        self._completed += 1

    # -- stats ---------------------------------------------------------------
    def reset_stats(self):
        """Zero the rate/occupancy accounting (not the pool or queue) —
        call after warm-up so steady-state numbers exclude it."""
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._decode_steps = 0
        self._prefill_time = 0.0
        self._occupancy_sum = 0.0
        self._util_sum = 0.0
        self._prefill_tokens = 0
        self._prefill_chunks = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._fused_windows = 0
        self._fused_iterations = 0
        self._fused_tokens = 0
        self._ttfts_s = []

    def stats(self):
        steps = max(self._decode_steps, 1)
        ttft = np.asarray(self._ttfts_s) * 1000.0
        return {
            'device': str(self.device),
            'decode_tokens_per_sec':
                (self._decode_tokens / self._decode_time
                 if self._decode_time else 0.0),
            'ttft_ms_mean': float(ttft.mean()) if ttft.size else None,
            'ttft_ms_p50':
                float(np.percentile(ttft, 50)) if ttft.size else None,
            'ttft_ms_p99':
                float(np.percentile(ttft, 99)) if ttft.size else None,
            'batch_occupancy': self._occupancy_sum / steps,
            'kv_page_utilization': self._util_sum / steps,
            'slots': self.config.max_batch_size,
            'in_flight': len(self.scheduler.running()),
            'waiting': len(self.scheduler.waiting),
            'pool': self.pool.stats(),
            'requests_submitted_total': self._submitted,
            'requests_completed_total': self._completed,
            'preemptions_total': self.scheduler.preemptions,
            'decode_steps_total': self._decode_steps,
            'decode_tokens_total': self._decode_tokens,
            'decode_seconds_total': self._decode_time,
            'prefill_tokens_total': self._prefill_tokens,
            'prefill_chunks_total': self._prefill_chunks,
            'prefill_seconds_total': self._prefill_time,
            'weight_dtype': (str(self.config.weight_dtype)
                             if self.config.weight_dtype else None),
            'quantized_params': len(self._qweights),
            'prefix_cache': self.pool.prefix_cache,
            'prefix_hits_total': self.pool.prefix_hits,
            'prefix_misses_total': self.pool.prefix_misses,
            'prefix_hit_tokens_total': self.pool.prefix_hit_tokens,
            'prefix_shared_pages': self.pool.shared_pages,
            'prefix_cached_pages': self.pool.cached_pages,
            'prefix_evictions_total': self.pool.prefix_evictions,
            'spec_k': self.config.spec_k,
            'spec_proposed_tokens_total': self._spec_proposed,
            'spec_accepted_tokens_total': self._spec_accepted,
            'spec_steps_total': self._spec_steps,
            'spec_acceptance_rate':
                (self._spec_accepted / self._spec_proposed
                 if self._spec_proposed else None),
            'fused_k': self.config.fused_k,
            'fused_windows_total': self._fused_windows,
            'fused_iterations_total': self._fused_iterations,
            'fused_tokens_total': self._fused_tokens,
        }

    def shutdown(self):
        """Drop the pool's device pages and the int8 weights."""
        self.pool.drop_arrays()
        self._qweights = {}
        return {'released': True}


def _dequantize_hook(attr, q, s, dtype):
    """Forward pre-hook: the module's weight becomes its dequantized
    int8 copy for this call."""
    def hook(mod, _args):
        mod._parameters[attr] = dequantize_weight(q, s, dtype)
    return hook


def _restore_hook(attr, param):
    """Forward hook: the module's own weight back, the copy dropped."""
    def hook(mod, _args, _out):
        mod._parameters[attr] = param
    return hook


def _ngram_propose(tokens, ngram, k):
    """Prompt-lookup draft proposer (engine.py:2147): find the most
    recent earlier occurrence of the context's trailing n-gram and
    propose the up-to-k tokens that followed it, backing off to shorter
    n-grams; [] when nothing matches. Host work on the token list."""
    L = len(tokens)
    if k <= 0 or L < 2:
        return []
    for n in range(min(int(ngram), L - 1), 0, -1):
        # the rightmost candidate ends one short of the trailing gram,
        # so the continuation (which may overlap the suffix: that is how
        # repetition loops propose) is never empty
        first = tokens[L - n]
        for j in range(L - n - 1, -1, -1):
            if tokens[j] != first:
                continue
            if all(tokens[j + t] == tokens[L - n + t] for t in range(1, n)):
                return [int(t) for t in tokens[j + n:j + n + k]]
    return []


def _ord_of(req):
    """The request's sampling ordinal: the engine-local one submit
    assigned, else (a request injected past submit) its global id."""
    o = req.sample_ord
    return int(o if o is not None else req.id)


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply) on int64 tensors
    holding values in [0, 2^32): every product stays below 2^63, so the
    int64 arithmetic is exact on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def sample_uniforms(seed, ords, positions, V):
    """[B, V] uniforms on (0, 1), a pure function of (seed, ords[b],
    positions[b], vocab index): counter-based, 24 bits each, exact in
    fp32, bit-identical on the CPU and the card."""
    row = _mix32(torch.full_like(ords, (int(seed) * _GOLDEN + 1) & _M32))
    row = _mix32(row ^ (ords & _M32))
    row = _mix32(row ^ (positions & _M32))[:, None]            # [B, 1]
    idx = torch.arange(V, device=ords.device, dtype=torch.int64)[None]
    h = _mix32((row + idx * _GOLDEN) & _M32)
    h = _mix32(h ^ row)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def top_k_mask(logits, temps, top_ks):
    """(kth, masked): the temperature-scaled logits with every value
    below the row's k-th largest set to -1e30 — the threshold from a
    full sort, so values tied with it stay in (engine.py:2208-2212)."""
    V = logits.shape[-1]
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    k = top_ks.clamp(1, V)
    srt = torch.sort(scaled, dim=-1).values                   # ascending
    kth = torch.gather(srt, 1, (V - k)[:, None])
    masked = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                         scaled)
    return kth, masked


def _device_sample(logits, seed, ords, positions, temps, top_ks):
    """Next token per row of fp32 logits [B, V] (engine.py:2184): greedy
    argmax where top_k <= 0; elsewhere the argmax of the top-k-masked,
    temperature-scaled logits plus Gumbel noise from `sample_uniforms`,
    a draw from their softmax. `positions` is the absolute index of the
    token drawn (the rows' seq_lens). No host sync."""
    greedy = torch.argmax(logits, dim=-1)
    _kth, masked = top_k_mask(logits, temps, top_ks)
    u = sample_uniforms(seed, ords, positions, logits.shape[-1])
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    return torch.where(top_ks > 0, sampled, greedy)
