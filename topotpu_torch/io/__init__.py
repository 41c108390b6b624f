"""Torch builders of tile inputs (worlds and files stay in ``topotpu.io``)."""
