"""paddle.nn.functional — counterpart of
`paddle_tpu/nn/functional/__init__.py`: the port's functional ops
(`ops/nn_ops.py`), re-exported flat."""
from ...ops.nn_ops import (adaptive_avg_pool2d,  # noqa: F401
                           adaptive_max_pool2d, avg_pool2d, batch_norm,
                           bias_gelu, celu, conv1d, conv2d, conv3d,
                           cross_entropy, dropout, dropout_add, elu,
                           embedding, flatten, fused_linear_cross_entropy,
                           gelu, hardshrink, hardsigmoid, hardswish,
                           hardtanh, layer_norm, leaky_relu, linear,
                           log_sigmoid, log_softmax, max_pool2d, maxout,
                           mish, prelu, relu, relu6, selu, sigmoid, silu,
                           softmax, softmax_with_cross_entropy, softplus,
                           softshrink, softsign, swish, tanh, tanhshrink,
                           thresholded_relu)
