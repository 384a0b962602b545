"""The contrib operators' names (reference python/mxnet/contrib codegen of
`_contrib_*` ops), as the JAX package's contrib lists them."""

CONTRIB_OPS = [
    'MultiBoxPrior', 'MultiBoxTarget', 'MultiBoxDetection', 'Proposal',
    'MultiProposal', 'PSROIPooling', 'DeformableConvolution',
    'DeformablePSROIPooling', 'ctc_loss', 'CTCLoss', 'fft', 'ifft',
    'count_sketch', 'quantize', 'dequantize',
]
