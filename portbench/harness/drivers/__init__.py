"""The drivers a traffic mix names (``"driver"``): ``train`` steps the
pretrain or the SSL step in a closed loop, ``eval`` serves eval requests
one at a time. Each returns the run's result (``harness.result``)."""
