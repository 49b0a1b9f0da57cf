"""paddle_tpu_torch GPT vs the JAX package's GPT on bridged weights.

A tiny JAX GPT (vocab 128, hidden 64, 2 layers, 2 heads, dropout 0 —
the `tiny_lm` fixture of tests/test_serving.py) is copied into the
port through `load_jax_params`, which must cover every name. Then one
`forward_paged` chunked-prefill step and one decode step, on the same
numpy inputs, must give the JAX model's hidden states and KV pages at
fp32 (atol 1e-4: matmul and softmax summation order differ).

The uncached forward: `__graft_entry__.entry()`'s GPT (vocab 4096,
hidden 256, 4 layers) gives the JAX logits at fp32, and the tiny GPT's
loss and every parameter's gradient equal `jax.value_and_grad` of the
JAX model's loss on the dense route (L=128) and the flash route (L=512,
the Pallas packed kernels in interpret mode against the port's flash
Function on the CPU). Logits, loss and gradients at the fp32 bars,
rtol 2e-4 / atol 2e-5 (matmul and softmax summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import load_jax_params

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=128, hidden_dropout=0.0, attn_dropout=0.0,
            use_flash_attention=False)


@pytest.fixture(scope='module')
def bridged():
    paddle.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    load_jax_params(tm, named)
    return jm, tm, named


def test_bridge_covers_every_name_with_paddle_layouts(bridged):
    jm, tm, named = bridged
    tnames = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert tnames == {n: a.shape for n, a in named.items()}
    # paddle layouts: Linear weights [in, out], qkv packed (head, 3, hd),
    # the LM head tied to the token embedding (no separate parameter)
    assert tnames['gpt.layers.0.attn.qkv_proj.weight'] == (64, 192)
    assert tnames['gpt.layers.1.mlp.fc1.weight'] == (64, 256)
    assert not any('head' in n for n in tnames)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), named[n])


def test_bridge_rejects_missing_extra_and_misshapen(bridged):
    _jm, _tm, named = bridged
    fresh = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY))
    before = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    missing = dict(named)
    missing.pop('gpt.final_norm.bias')
    with pytest.raises(KeyError, match='final_norm.bias'):
        load_jax_params(fresh, missing)
    with pytest.raises(KeyError, match='extra'):
        load_jax_params(fresh, {**named, 'gpt.lm_head.weight': np.zeros(3)})
    bad = dict(named)
    bad['gpt.layers.0.ln1.weight'] = np.zeros(63, np.float32)
    with pytest.raises(ValueError, match='ln1.weight'):
        load_jax_params(fresh, bad)
    # nothing was copied by the failed loads
    for n, p in fresh.named_parameters():
        assert torch.equal(p, before[n])


def test_bridge_accepts_bf16_arrays():
    paddle.seed(3)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    named = {n: np.asarray(p.data.astype(jnp.bfloat16))
             for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY), dtype=torch.bfloat16)
    load_jax_params(tm, named)
    w = 'gpt.embeddings.word_embeddings.weight'
    np.testing.assert_array_equal(
        dict(tm.named_parameters())[w].detach().float().numpy(),
        named[w].astype(np.float32))


def _step_inputs(tokens, page_tables, seq_lens, q_lens, max_pos=127):
    T = tokens.shape[1]
    pos = np.clip(seq_lens[:, None] - q_lens[:, None]
                  + np.arange(T, dtype=np.int32)[None], 0, max_pos)
    return tokens, pos.astype(np.int32), page_tables, seq_lens, q_lens


def _run_both(jm, tm, jkv, tkv, inputs):
    tokens, pos, pt, sl, ql = inputs
    with no_grad():
        jh, jkv = jm.gpt.forward_paged(
            Tensor(jnp.asarray(tokens)), Tensor(jnp.asarray(pos)),
            [(Tensor(k), Tensor(v)) for k, v in jkv], jnp.asarray(pt),
            jnp.asarray(sl), jnp.asarray(ql))
    with torch.inference_mode():
        th, tkv = tm.gpt.forward_paged(
            *(torch.from_numpy(a) for a in (tokens, pos)), tkv,
            *(torch.from_numpy(a) for a in (pt, sl, ql)))
    jkv = [(k.data, v.data) for k, v in jkv]
    return np.asarray(jh.data), th.numpy(), jkv, tkv


def test_forward_paged_prefill_then_decode_matches_jax(bridged):
    jm, tm, _named = bridged
    tm.eval()
    N, ps, HD = 12, 4, 64
    jkv = [(jnp.zeros((N, ps, HD)), jnp.zeros((N, ps, HD)))
           for _ in range(2)]
    tkv = [(torch.zeros(N, ps, HD), torch.zeros(N, ps, HD))
           for _ in range(2)]
    rng = np.random.RandomState(0)
    # chunked prefill, T=8: a fresh 8-token row, a 5-token row (padded),
    # and the engine's idle slot (q_len 0, page row of zeros)
    pt = np.asarray([[3, 1, 0, 0], [5, 7, 2, 0], [0, 0, 0, 0]], np.int32)
    tokens = rng.randint(1, 128, (3, 8)).astype(np.int32)
    inputs = _step_inputs(tokens, pt, np.asarray([8, 5, 1], np.int32),
                          np.asarray([8, 5, 0], np.int32))
    jh, th, jkv, tkv = _run_both(jm, tm, jkv, tkv, inputs)
    np.testing.assert_allclose(th, jh, atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert not tkv[0][0][0].any()           # the idle slot wrote nothing
    # one decode step on the pages just written (T=1, seq_len + 1)
    tokens = rng.randint(1, 128, (3, 1)).astype(np.int32)
    inputs = _step_inputs(tokens, pt, np.asarray([9, 6, 1], np.int32),
                          np.asarray([1, 1, 0], np.int32))
    jh, th, jkv, tkv = _run_both(jm, tm, jkv, tkv, inputs)
    np.testing.assert_allclose(th, jh, atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_presets_match_jax():
    for name in ('gpt_tiny', 'gpt_small', 'gpt_medium', 'gpt_1p3b'):
        assert vars(getattr(tgpt, name)()) == vars(getattr(jgpt, name)())


def test_unported_forwards_raise(bridged):
    # the uncached forward is ported; the dense-cache decode is not
    _jm, tm, _named = bridged
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match='not ported'):
        tm.gpt(ids, caches=[None, None])
    with pytest.raises(NotImplementedError, match='not ported'):
        tm.gpt.layers[0].attn(torch.zeros(1, 4, 64), cache=(None, None))


def test_entry_config_logits_match_jax():
    import __graft_entry__
    forward, (params, ids) = __graft_entry__.entry()
    want = np.asarray(forward(params, ids))
    cfg = tgpt.GPTConfig(vocab_size=4096, hidden_size=256, num_layers=4,
                         num_heads=8, max_seq_len=256, hidden_dropout=0.0,
                         attn_dropout=0.0, use_flash_attention=False)
    tm = tgpt.GPTForCausalLM(cfg)
    load_jax_params(tm, {n: np.asarray(a) for n, a in params.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(ids))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('L', [128, 512], ids=['dense', 'flash'])
def test_loss_and_every_gradient_match_jax(L):
    from paddle_tpu.jit import bind_arrays
    cfg = dict(TINY, max_seq_len=512, use_flash_attention=True)
    paddle.seed(11)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    jcrit = jgpt.GPTPretrainingCriterion()
    params = {n: p.data for n, p in jm.named_parameters()}
    rng = np.random.RandomState(L)
    ids = rng.randint(0, 128, (2, L)).astype(np.int32)
    labels = np.roll(ids, -1, 1)

    def loss_of(ps):
        with bind_arrays(jm, ps), no_grad():
            return jcrit(jm(Tensor(jnp.asarray(ids))),
                         Tensor(jnp.asarray(labels))).data.astype(
                             jnp.float32)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg))
    load_jax_params(tm, {n: np.asarray(a) for n, a in params.items()})
    from paddle_tpu_torch.ops.kernels import _build
    tloss = tgpt.GPTPretrainingCriterion()(
        tm(torch.from_numpy(ids)), torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=2e-4, atol=2e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]),
                                   err_msg=n, **GRAD)
    assert all(v == 0 for v in _build.routes_snapshot().values())


def test_criterion_with_loss_mask_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 8, 16).astype(np.float32)
    labels = rng.randint(0, 16, (2, 8)).astype(np.int32)
    labels[0, 3] = -100                                   # ignore_index
    mask = (rng.rand(2, 8) > 0.3).astype(np.float32)
    with no_grad():
        want = jgpt.GPTPretrainingCriterion()(
            Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(labels)),
            Tensor(jnp.asarray(mask)))
    crit = tgpt.GPTPretrainingCriterion()
    got = crit(torch.from_numpy(logits), torch.from_numpy(labels),
               torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want.data), rtol=2e-4,
                               atol=2e-5)
