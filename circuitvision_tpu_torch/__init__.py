"""circuitvision_tpu_torch — the PyTorch/CUDA port of circuitvision_tpu.

Image of a circuit → SPICE netlist on one NVIDIA H100: YOLOv11 detection,
cluster crop, prompt-free SAM2 segmentation, topology and netlist text,
with hand-written CUDA kernels in place of the JAX package's Pallas
kernels (ops/cuda/, csrc/). Entry point:
`circuitvision_tpu_torch.pipeline.analyzer.CircuitAnalyzerTorch`.
Importing the package builds nothing and needs no GPU.
"""
