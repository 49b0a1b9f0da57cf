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
from torch_threads import one_intra_op_thread  # noqa: F401

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
            [tuple(Tensor(a) for a in layer) for layer in jkv],
            jnp.asarray(pt), jnp.asarray(sl), jnp.asarray(ql))
    with torch.inference_mode():
        th, tkv = tm.gpt.forward_paged(
            *(torch.from_numpy(a) for a in (tokens, pos)), tkv,
            *(torch.from_numpy(a) for a in (pt, sl, ql)))
    jkv = [tuple(a.data for a in layer) for layer in jkv]
    return np.asarray(jh.data), th.numpy(), jkv, tkv


def test_forward_paged_prefill_then_decode_matches_jax(bridged):
    jm, tm, _named = bridged
    tm.eval()
    N, ps, HD = 12, 4, 64
    jkv = [(jnp.zeros((N, ps, HD)), jnp.zeros((N, ps, HD)))
           for _ in range(2)]
    # the port's pool tensors end in the sink page (index N)
    tkv = [(torch.zeros(N + 1, ps, HD), torch.zeros(N + 1, ps, HD))
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
        np.testing.assert_allclose(tk[:N].numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv[:N].numpy(), np.asarray(jv), atol=1e-5)
    assert not tkv[0][0][0].any()           # the idle slot wrote nothing
    # one decode step on the pages just written (T=1, seq_len + 1)
    tokens = rng.randint(1, 128, (3, 1)).astype(np.int32)
    inputs = _step_inputs(tokens, pt, np.asarray([9, 6, 1], np.int32),
                          np.asarray([1, 1, 0], np.int32))
    jh, th, jkv, tkv = _run_both(jm, tm, jkv, tkv, inputs)
    np.testing.assert_allclose(th, jh, atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk[:N].numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv[:N].numpy(), np.asarray(jv), atol=1e-5)


def test_forward_paged_int8_pool_matches_jax(bridged):
    # the 4-tuple route (gpt.py:282-299): new K/V quantized per (token,
    # head) as it is written, attention over the dequantized pages. The
    # idle slot and padding write into the sink page (index N), which
    # the JAX pool has not, and nothing else changes
    jm, tm, _named = bridged
    tm.eval()
    N, ps, HD, H = 12, 4, 64, 2
    jkv = [(jnp.zeros((N, ps, HD), jnp.int8), jnp.zeros((N, ps, HD), jnp.int8),
            jnp.zeros((N, ps, H)), jnp.zeros((N, ps, H))) for _ in range(2)]
    tkv = [(torch.zeros(N + 1, ps, HD, dtype=torch.int8),
            torch.zeros(N + 1, ps, HD, dtype=torch.int8),
            torch.zeros(N + 1, ps, H), torch.zeros(N + 1, ps, H))
           for _ in range(2)]
    rng = np.random.RandomState(1)
    pt = np.asarray([[3, 1, 0, 0], [5, 7, 2, 0], [0, 0, 0, 0]], np.int32)
    steps = [(rng.randint(1, 128, (3, 8)).astype(np.int32), [8, 5, 1],
              [8, 5, 0]),
             (rng.randint(1, 128, (3, 1)).astype(np.int32), [9, 6, 1],
              [1, 1, 0])]
    for tokens, sl, ql in steps:
        inputs = _step_inputs(tokens, pt, np.asarray(sl, np.int32),
                              np.asarray(ql, np.int32))
        jh, th, jkv, tkv = _run_both(jm, tm, jkv, tkv, inputs)
        np.testing.assert_allclose(th, jh, atol=1e-4, rtol=1e-4)
        for jl, tl in zip(jkv, tkv):
            for jc, js, tc, ts in ((jl[0], jl[2], tl[0], tl[2]),
                                   (jl[1], jl[3], tl[1], tl[3])):
                # the projections agree to fp32 rounding, so a code may
                # sit one off where a value lies on a rounding boundary:
                # dequantized rows within one step of the scale
                js, ts = np.asarray(js), ts[:N].numpy()
                np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
                deq_j = np.asarray(jc, np.float32).reshape(N, ps, H, -1) \
                    * js[..., None]
                deq_t = tc[:N].float().numpy().reshape(N, ps, H, -1) \
                    * ts[..., None]
                assert (np.abs(deq_t - deq_j)
                        <= js[..., None] * 1.001 + 1e-7).all()
                assert (np.asarray(jc) != tc[:N].numpy()).mean() < 0.01
        # the idle slot (position 1 of page 0) never writes; page 0's
        # slot 0 is row 0's position 8, written by the decode step
        assert not tkv[0][0][0, 1:].any() and not tkv[0][2][0, 1:].any()
    assert tkv[0][0][N].any() and tkv[0][2][N].any()


def test_presets_match_jax():
    for name in ('gpt_tiny', 'gpt_small', 'gpt_medium', 'gpt_1p3b'):
        assert vars(getattr(tgpt, name)()) == vars(getattr(jgpt, name)())


def test_unported_forwards_raise(bridged):
    # every forward of the model is ported now: the dense-cache decode
    # (which raised before) takes caches and returns them written at
    # cache_len; its values are held in tests/test_torch_gpt_decode.py
    _jm, tm, _named = bridged
    ids = torch.zeros(1, 1, dtype=torch.long)
    caches = tm.gpt.init_caches(1, 8)
    with torch.no_grad():
        h, new = tm.gpt(ids, torch.tensor([3]), caches=caches, cache_len=3)
    assert h.shape == (1, 1, 64) and len(new) == 2
    assert all(k is c[0] and v is c[1] for (k, v), c in zip(new, caches))
    assert float(new[0][0][:, :, 3].abs().sum()) > 0
    assert float(new[0][0][:, :, 4:].abs().sum()) == 0


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
