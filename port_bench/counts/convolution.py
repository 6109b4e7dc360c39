"""The device time of a traced window's convolution kernels.

A convolution on the card is the kernels cuDNN launches for it, forward,
data gradient and filter gradient: its own implicit GEMMs and helpers
(`..._cudnn`: `sm90_xmma_{fprop,dgrad,wgrad}_..._cudnn`, `cask_plugin__5x_cudnn`,
`cutlass__5x_cudnn`, the padding and layout transforms `nhwcAddPaddingKernel<...
cudnnKernelDataType_t ...>` and `cudnn::engines_precompiled::...`), and the
cuBLASLt and CUTLASS GEMMs it hands a 1x1 layer to (`nvjet_...`, their
`cublasLt::splitKreduce_kernel`, the bf16 tensor-op `cutlass_80_..._s16816gemm_...`).
`FRAGMENTS` are pieces of those names, taken from the training cells'
traced steps on an NVIDIA H100 (torch 2.11, CUDA 12.8, cuDNN 9.2), where
each kernel was put down to the operator that launched it.

Left out: the ATen kernels a convolution operator also launches, the bias
add (`elementwise_kernel<128, 4, ...CUDAFunctor_add<c10::BFloat16>>`) and the
bias gradient's sum (`reduce_kernel<...sum_functor...>`), whose names other
operators share; and the float32 GEMMs of the device augment (`cutlass_80_simt_sgemm_...`,
`sm80_xmma_gemm_f32f32_..._cublas`), which no fragment matches.  In the
classifier's cell the dense layer's cuBLAS GEMMs (`nvjet_...`, 0.03 ms a
step) are counted with the convolutions.
"""

from __future__ import annotations

from port_bench.trace import kernel_seconds

FRAGMENTS = ("cudnn", "nvjet", "cublasLt::splitKreduce", "s16816gemm")


def seconds(record: dict) -> float:
    """Device seconds of the window's convolution kernels."""
    return kernel_seconds(record, *FRAGMENTS)
