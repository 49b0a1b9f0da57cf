"""Seq2seq decoding — counterpart of `paddle_tpu/nn/decode.py`: the
`Decoder` contract, `BeamSearchDecoder`, `dynamic_decode`, the three
helpers and `BasicDecoder`, with `gather_tree`
(`paddle_tpu/ops/contrib.py:485-510`) as a private function until the
op tail (item 9c) ports `ops/contrib.py`.

Beams live as one flattened [B * W, ...] batch through the cell. Token
and parent ids are int64 (torch's index type; the reference's are
int32). Top-k ties: `jax.lax.top_k` returns the lower flat index first,
and frozen finished beams put many candidates at -1e9, where
`torch.topk` on the card promises no order; the step takes the first W
of a STABLE descending sort instead, which keeps the lower index first.
`dynamic_decode` reads the all-finished flag back to the host once a
step, as the reference does.
"""
import torch
import torch.nn.functional as F


def _map(fn, *trees):
    """Apply `fn` leaf by leaf over matching dicts, tuples and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _gather_tree(ids, parents):
    """Backtrace beam selections [T, B, W] into full sequences: from the
    last step's beams, gather each step's ids along the parents."""
    T, B, W = ids.shape
    beams = torch.arange(W, device=ids.device).expand(B, W)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, beams)
        beams = parents[t].gather(1, beams)
    return out


class Decoder:
    """initialize() -> (initial_inputs, initial_states, initial_finished);
    step() -> (outputs, next_states, next_inputs, finished); optional
    finalize()."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a one-step cell, `cell(inputs, states) ->
    (outputs, states)`; `embedding_fn` maps ids to cell inputs,
    `output_fn` cell outputs to vocabulary logits. A finished beam is
    frozen: it may only emit `end_token`, at log-prob 0."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _expand_to_beams(self, x):
        return torch.as_tensor(x).repeat_interleave(self.beam_size, dim=0)

    def initialize(self, initial_cell_states):
        states = _map(self._expand_to_beams, initial_cell_states)
        leaf = _leaves(states)[0]
        BW, dev = leaf.shape[0], leaf.device
        B = BW // self.beam_size
        self._batch = B
        tokens = torch.full((BW,), self.start_token, dtype=torch.int64,
                            device=dev)
        inputs = self.embedding_fn(tokens) if self.embedding_fn else tokens
        # beam 0 starts live, the rest at -1e9, so the first step fans out
        # from one hypothesis an example
        lp = torch.full((B, self.beam_size), -1e9, dtype=torch.float32,
                        device=dev)
        lp[:, 0] = 0.0
        finished = torch.zeros((B, self.beam_size), dtype=torch.bool,
                               device=dev)
        return inputs, {'cell': states, 'log_probs': lp,
                        'finished': finished,
                        'lengths': torch.zeros((B, self.beam_size),
                                               dtype=torch.int64,
                                               device=dev)}, finished

    def step(self, time, inputs, states, **kwargs):
        B, W = self._batch, self.beam_size
        cell_out, next_cell = self.cell(inputs, states['cell'])
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        V = logits.shape[-1]
        step_lp = F.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
        finished = states['finished']
        frozen = torch.full((V,), -1e9, dtype=step_lp.dtype,
                            device=step_lp.device)
        frozen[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], frozen, step_lp)
        total = states['log_probs'][..., None] + step_lp        # [B, W, V]
        flat = total.reshape(B, W * V)
        scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        scores, idx = scores[:, :W], idx[:, :W]
        parent = idx // V
        token = idx % V
        gather = (torch.arange(B, device=idx.device)[:, None] * W
                  + parent).reshape(-1)
        next_cell = _map(lambda t: t.index_select(0, gather), next_cell)
        was_done = finished.gather(1, parent)
        now_done = was_done | (token == self.end_token)
        lengths = states['lengths'].gather(1, parent)
        lengths = torch.where(was_done, lengths, lengths + 1)
        ids = token.reshape(-1)
        next_inputs = self.embedding_fn(ids) if self.embedding_fn else ids
        outputs = {'scores': scores, 'predicted_ids': token,
                   'parent_ids': parent}
        next_states = {'cell': next_cell, 'log_probs': scores,
                       'finished': now_done, 'lengths': lengths}
        return outputs, next_states, next_inputs, now_done

    def finalize(self, outputs, final_states, sequence_lengths):
        seqs = _gather_tree(outputs['predicted_ids'], outputs['parent_ids'])
        return {'scores': outputs['scores'], 'predicted_ids': seqs}, \
            final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step `decoder` until every sequence has finished (one host read a
    step) or `max_step_num` (256 when None) steps; stack each output
    along time, finalize, and return (outputs, final_states[,
    sequence_lengths]), batch-major unless `output_time_major`."""
    inputs, states, finished = decoder.initialize(inits)
    per_step = []
    step = 0
    max_steps = int(max_step_num) if max_step_num is not None else 256
    while step < max_steps and not bool(torch.as_tensor(finished).all()):
        out, states, inputs, finished = decoder.step(step, inputs, states,
                                                     **kwargs)
        per_step.append(out)
        step += 1
    outputs = _map(lambda *xs: torch.stack(xs, dim=0), *per_step) \
        if per_step else {}
    seq_len = states.get('lengths') if isinstance(states, dict) else None
    try:
        outputs, final_states = decoder.finalize(outputs, states, seq_len)
    except NotImplementedError:
        final_states = states
    if not output_time_major:
        outputs = _map(lambda t: t.transpose(0, 1) if t.dim() >= 2 else t,
                       outputs)
    if return_length:
        return outputs, final_states, seq_len
    return outputs, final_states


class DecodeHelper:
    """initialize() -> (initial_inputs, initial_finished);
    sample(time, outputs, states) -> sample_ids;
    next_inputs(time, outputs, states, sample_ids) ->
    (finished, next_inputs, next_states)."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: the next input is the ground truth's."""

    def __init__(self, inputs, sequence_length, time_major=False):
        self.inputs = torch.as_tensor(inputs)
        self.sequence_length = torch.as_tensor(sequence_length)
        self.time_major = time_major
        self._seq = self.inputs if time_major \
            else self.inputs.transpose(0, 1)                    # [T, B, ..]
        self._T = self._seq.shape[0]

    def initialize(self):
        lens = self.sequence_length.reshape(-1)
        return self._seq[0], lens <= 0

    def sample(self, time, outputs, states):
        return outputs.argmax(dim=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        nxt = min(time + 1, self._T - 1)
        lens = self.sequence_length.reshape(-1)
        finished = (time + 1) >= torch.clamp(lens, max=self._T)
        return finished, self._seq[nxt], states


class GreedyEmbeddingHelper(DecodeHelper):
    """Inference-time argmax feeding."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = torch.as_tensor(start_tokens)
        self.end_token = int(end_token)

    def initialize(self):
        toks = self.start_tokens.reshape(-1).to(torch.int64)
        return self.embedding_fn(toks), torch.zeros(
            toks.shape, dtype=torch.bool, device=toks.device)

    def sample(self, time, outputs, states):
        return outputs.argmax(dim=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        return sample_ids == self.end_token, self.embedding_fn(sample_ids), \
            states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Multinomial sampling feeding: from the package generator of the
    outputs' device, or, with `seed`, from a generator seeded from
    (seed, time)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self.seed = seed

    def sample(self, time, outputs, states):
        from ..core import rng
        o = outputs.float()
        if self.temperature is not None:
            o = o / self.temperature
        if self.seed is None:
            gen = rng.generator(o.device)
        else:
            gen = torch.Generator(device=o.device)
            gen.manual_seed(int(self.seed) * 1000003 + int(time))
        return torch.multinomial(F.softmax(o, dim=-1), 1,
                                 generator=gen).reshape(o.shape[:-1])


class BasicDecoder(Decoder):
    """Cell + helper: each step runs the cell, lets the helper sample
    ids and make the next inputs. Outputs: cell_outputs, sample_ids."""

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        inputs, finished = self.helper.initialize()
        return inputs, initial_cell_states, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_states = self.cell(inputs, states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        sample_ids = self.helper.sample(time, cell_out, next_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_out, next_states, sample_ids)
        outputs = {'cell_outputs': cell_out, 'sample_ids': sample_ids}
        return outputs, next_states, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states
