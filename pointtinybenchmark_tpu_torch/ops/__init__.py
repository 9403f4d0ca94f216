"""Hand-written CUDA kernels and their plain PyTorch versions: NMS (nms,
nms_cuda) and multilevel RoIAlign (roi_align, roi_align_cuda), built by
cuda_build."""
