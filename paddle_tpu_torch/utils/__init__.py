"""paddle.utils — counterpart of `paddle_tpu/utils`: `download`, the
dataset cache path."""
