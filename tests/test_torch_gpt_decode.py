"""paddle_tpu_torch GPT's dense-cache decode against `paddle_tpu`'s on
bridged weights: `GPTModel.forward(caches=..., cache_len=...)` step by
step (logits at the kernels' plain-version fp32 bar, rtol 2e-4 / atol
2e-5: summation order), and the greedy tokens of `generate` (the cached
route, `use_cache=False`, and the sliding window beyond max_seq_len, EOS
per row) and of `generate_scan`, which must equal JAX's. Sampled tokens
are held within the port only (JAX's threefry stream cannot be
matched): a seed reproduces them, top_k=1 is greedy, and every drawn
token is among its step's top k.

The model: vocab 128, hidden 64, 2 layers of 2 heads, max_seq_len 48,
dropout 0, fp32, on the CPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.ops.kernels import fused_elementwise as tfe
from paddle_tpu_torch.ops.kernels import fused_norm as tfln
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=48, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=True)
FP32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope='module')
def bridged():
    paddle.seed(23)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    load_jax_params(tm, {n: np.asarray(p.data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _prompts(B=3, L0=6, seed=0):
    return np.random.RandomState(seed).randint(
        0, TINY['vocab_size'], (B, L0)).astype('int32')


def _tokens(t):
    return np.asarray(t.data if isinstance(t, Tensor) else t).astype(
        np.int64)


def test_forward_cached_logits_match_jax(bridged):
    jm, tm = bridged
    ids = _prompts(B=2, L0=10, seed=1)
    B, max_len = ids.shape[0], 16
    jc = jm.gpt.init_caches(B, max_len)
    tc = tm.gpt.init_caches(B, max_len)
    assert tuple(tc[0][0].shape) == (B, 2, max_len, 32)
    assert tc[0][0].dtype == torch.float32
    w_j = jm.gpt.embeddings.word_embeddings.weight.data
    for pos in range(ids.shape[1]):
        tok = ids[:, pos:pos + 1]
        with no_grad():
            jh, jc = jm.gpt(Tensor(tok), Tensor(np.asarray([pos], 'int32')),
                            caches=jc, cache_len=pos)
        with torch.no_grad():
            th, tc = tm.gpt(torch.from_numpy(tok), torch.tensor([pos]),
                            caches=tc, cache_len=pos)
        jlog = np.asarray(jh.data) @ np.asarray(w_j).T
        tlog = (th @ tm.gpt.embeddings.word_embeddings.weight.t()
                ).detach().numpy()
        np.testing.assert_allclose(tlog, jlog, **FP32)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk.data), **FP32)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv.data), **FP32)


def test_cached_decode_runs_the_norm_and_bias_gelu_routes(bridged,
                                                          monkeypatch):
    """A decode step's LayerNorms and bias+GELU go through the kernels'
    routes (their plain versions on the CPU): two norms a block and the
    final one, one bias+GELU (tanh form) a block, as chip_smoke.py's
    `decode_launches` counts them on the card."""
    _jm, tm = bridged
    calls = {'layer_norm': 0, 'bias_gelu': 0}
    for name, mod, attr in (('layer_norm', tfln, 'layer_norm_plain'),
                            ('bias_gelu', tfe, 'bias_gelu_plain')):
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    tm.generate(_prompts(B=2, L0=4), max_new_tokens=3, device='cpu')
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert calls == smoke.decode_launches(TINY['num_layers'], 4 + 3)


# the JAX package's uncached route compiles each new window length, so
# it takes fewer tokens
@pytest.mark.parametrize('use_cache,new', [(True, 12), (False, 5)],
                         ids=['cached', 'uncached'])
def test_greedy_generate_matches_jax(bridged, use_cache, new):
    jm, tm = bridged
    ids = _prompts()
    want = _tokens(jm.generate(ids, max_new_tokens=new, use_cache=use_cache))
    got = tm.generate(ids, max_new_tokens=new, use_cache=use_cache,
                      device='cpu')
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    np.testing.assert_array_equal(_tokens(got), want)


def test_generate_scan_matches_jax_and_generate(bridged):
    jm, tm = bridged
    ids = _prompts(seed=2)
    want = _tokens(jm.generate_scan(ids, max_new_tokens=10))
    got = _tokens(tm.generate_scan(ids, max_new_tokens=10, device='cpu'))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _tokens(tm.generate(ids, max_new_tokens=10, device='cpu')))
    with pytest.raises(ValueError, match='max_seq_len'):
        tm.generate_scan(ids, max_new_tokens=43, device='cpu')


def test_eos_stops_when_every_row_has_emitted_it(bridged):
    jm, tm = bridged
    ids = _prompts(B=4, seed=3)
    free = _tokens(tm.generate(ids, max_new_tokens=10, device='cpu'))
    eos = int(free[0, ids.shape[1] + 1])        # row 0's second new token
    want = _tokens(jm.generate(ids, max_new_tokens=10, eos_token_id=eos))
    for use_cache in (True, False):
        got = _tokens(tm.generate(ids, max_new_tokens=10, eos_token_id=eos,
                                  use_cache=use_cache, device='cpu'))
        np.testing.assert_array_equal(got, want)
        new = got[:, ids.shape[1]:]
        # rows that emitted it early kept emitting until the last row did
        assert (new == eos).any(axis=1).all() or new.shape[1] == 10
        np.testing.assert_array_equal(got, free[:, :got.shape[1]])


def test_beyond_max_seq_len_takes_the_sliding_window(bridged):
    jm, tm = bridged
    ids = _prompts(B=2, L0=46, seed=4)      # the windows: 46, 47, then 48
    want = _tokens(jm.generate(ids, max_new_tokens=6))
    got = _tokens(tm.generate(ids, max_new_tokens=6, device='cpu'))
    assert got.shape == (2, 52)
    np.testing.assert_array_equal(got, want)


def test_sampling_is_held_within_the_port(bridged):
    _jm, tm = bridged
    ids = _prompts(seed=5)
    a = tm.generate_scan(ids, max_new_tokens=8, top_k=5, seed=7,
                         device='cpu')
    b = tm.generate_scan(ids, max_new_tokens=8, top_k=5, seed=7,
                         device='cpu')
    assert torch.equal(a, b)
    greedy = tm.generate_scan(ids, max_new_tokens=8, device='cpu')
    assert torch.equal(tm.generate_scan(ids, max_new_tokens=8, top_k=1,
                                        seed=3, device='cpu'), greedy)
    # every drawn token is among the top 5 of its step's logits
    with torch.no_grad():
        logits = tm(a[:, :-1].long())
    top = logits[:, ids.shape[1] - 1:].topk(5, dim=-1).indices
    drawn = a[:, ids.shape[1]:].long()
    assert bool((top == drawn[..., None]).any(-1).all())
    np.random.seed(11)
    c = tm.generate(ids, max_new_tokens=8, top_k=5, device='cpu')
    np.random.seed(11)
    d = tm.generate(ids, max_new_tokens=8, top_k=5, device='cpu')
    assert torch.equal(c, d)
    assert torch.equal(tm.generate(ids, max_new_tokens=8, top_k=1,
                                   device='cpu').long(), greedy.long())


def test_generate_needs_the_card_unless_asked(bridged, monkeypatch):
    _jm, tm = bridged
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for fn in (tm.generate, tm.generate_scan):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            fn(_prompts(), max_new_tokens=2)


def test_decode_restores_the_training_mode(bridged):
    _jm, tm = bridged
    tm.train()
    tm.generate(_prompts(), max_new_tokens=2, device='cpu')
    tm.generate_scan(_prompts(), max_new_tokens=2, device='cpu')
    assert tm.training
    tm.eval()
