"""Box geometry, rotated IoU, chamfer distances and NMS."""
