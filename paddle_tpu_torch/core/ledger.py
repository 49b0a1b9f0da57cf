"""Analytic FLOPs and the card's compute peak — the subset of
`paddle_tpu/core/ledger.py` the serving ledger needs:
`model_flops_per_step` (:112 there) and `resolve_peak_tflops` (:91),
with the peak keyed on the CUDA device name instead of a TPU generation.
"""

__all__ = ['model_flops_per_step', 'resolve_peak_tflops',
           'PEAK_TFLOPS_BF16']

# dense bf16 peak TFLOP/s by CUDA device name — the MFU denominator.
# Only cards whose figures are stated: NVIDIA's H100 SXM data sheet.
PEAK_TFLOPS_BF16 = {
    'NVIDIA H100 80GB HBM3': 989.0,
}


def resolve_peak_tflops(device_kind=None):
    """The card's dense bf16 peak by its CUDA device name (None = the
    local card), or None for the CPU and for a card the table lacks."""
    if device_kind is None:
        import torch
        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else None)
    return PEAK_TFLOPS_BF16.get(str(device_kind)) if device_kind else None


def model_flops_per_step(n_params, tokens, layers=0, hidden=0,
                         seq_len=0, arch='gpt'):
    """(total_model_flops, attn_flops) per step, fwd+bwd.

    6*N*T counts every matmul touching a parameter (2 flops/MAC x fwd
    + 2x bwd); the attention-score term 12*l*h*L*T adds the
    parameter-free QK^T and probs*V contractions. GPT and BERT share the
    formula; `arch` is recorded, not branched on.
    """
    dense = 6.0 * float(n_params) * float(tokens)
    attn = 0.0
    if layers and hidden and seq_len:
        attn = 12.0 * float(layers) * float(hidden) \
            * float(seq_len) * float(tokens)
    return dense + attn, attn
