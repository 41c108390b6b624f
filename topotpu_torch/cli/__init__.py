"""The pipeline CLI: ``python -m topotpu_torch.cli <stage>`` (the port of
``topotpu.cli``)."""
