"""The benchmark's plain reference of VoteNet-IoU: a frozen copy of the
port's plain PyTorch code (models, losses, steps, IoU optimisation) and of
its NumPy parse, with every hand kernel replaced by its plain version
(``ops/__init__.py``) and the data-parallel paths taken out. It imports
nothing of the port, so a later change to the port cannot move it."""
