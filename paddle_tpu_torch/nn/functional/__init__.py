"""paddle.nn.functional — counterpart of
`paddle_tpu/nn/functional/__init__.py`: the port's functional ops
(`ops/nn_ops.py`, and the few of `ops/math.py`, `ops/manip.py` the
reference re-exports here), flat."""
from ...ops.manip import one_hot, pad, pixel_shuffle  # noqa: F401
from ...ops.math import diag_embed  # noqa: F401
from ...ops.nn_ops import (adaptive_avg_pool2d,  # noqa: F401
                           adaptive_max_pool2d, avg_pool2d, batch_norm,
                           bias_gelu, binary_cross_entropy,
                           binary_cross_entropy_with_logits, celu, conv1d,
                           conv1d_transpose, conv2d, conv2d_transpose,
                           conv3d, conv3d_transpose, cosine_embedding_loss,
                           cross_entropy, ctc_loss, dice_loss, dropout,
                           dropout_add, elu, embedding, flatten,
                           fused_linear_cross_entropy, gelu, hardshrink,
                           hardsigmoid, hardswish, hardtanh, hinge_loss,
                           kl_div, l1_loss, label_smooth, layer_norm,
                           leaky_relu, linear, log_loss, log_sigmoid,
                           log_softmax, margin_ranking_loss, max_pool2d,
                           maxout, mish, mse_loss, multi_margin_loss,
                           nll_loss, npair_loss, prelu, relu, relu6, selu,
                           sigmoid, sigmoid_focal_loss, silu,
                           smooth_l1_loss, soft_margin_loss, softmax,
                           softmax_with_cross_entropy, softplus, softshrink,
                           softsign, square_error_cost, swish, tanh,
                           tanhshrink, thresholded_relu, triplet_margin_loss)
sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits
