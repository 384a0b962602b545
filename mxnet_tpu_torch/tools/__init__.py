"""The port's command-line tools (`python -m mxnet_tpu_torch.tools.<name>`):
the runner of scripts written for the JAX package (`run_script`), the
counterparts of the JAX package's tools (`launch`, `im2rec`,
`bandwidth`, `serve_http`, `serve_fleet`, `bench_conv_bn`) and the
port's own checks (`op_consistency`, `kernel_digest`)."""
