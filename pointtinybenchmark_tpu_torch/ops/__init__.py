"""NMS on the hand-written IoU-bitmask kernel pair (nms, nms_cuda)."""
