"""AMP op lists (↔ paddle_tpu/amp/amp_lists.py, a copy: the port imports
nothing of the JAX package). WHITE_LIST: compute-bound ops that are safe and
fast in low precision; BLACK_LIST: numerically sensitive ops kept in f32.
The names are the op names the port's functionals pass to
`paddle_tpu_torch.amp.cast_inputs`, which are the JAX package's run_op
names."""

WHITE_LIST = {
    "conv1d",
    "conv2d",
    "conv3d",
    "conv1d_transpose",
    "conv2d_transpose",
    "conv3d_transpose",
    "matmul",
    "linear",
    "mm",
    "bmm",
    "einsum",
    "mul",
    "flash_attention",
    "sdpa",
    "flashmask_attention",
}

BLACK_LIST = {
    "exp",
    "square",
    "log",
    "log2",
    "log10",
    "log1p",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "log_softmax",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "sigmoid_focal_loss",
    "bce",
    "bce_with_logits",
    "ctc_loss",
    "kl_div",
    "layer_norm",
    "batch_norm",
    "group_norm",
    "instance_norm",
    "rms_norm",
    "norm",
    "cumsum",
    "cumprod",
    "logsumexp",
    "erf",
    "erfinv",
    "pow",
    "std",
    "var",
}
