"""Layer modules, laid out as paddle_tpu/nn/layer."""
