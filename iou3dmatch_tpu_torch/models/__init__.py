"""VoteNet with the GridConv IoU branch, channels-last PyTorch modules."""
