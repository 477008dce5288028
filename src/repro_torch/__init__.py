"""PyTorch / CUDA port of the DPPF system for NVIDIA Hopper.

Mirrors ``src/repro``'s layout module for module; imports torch, numpy and
the standard library only. ``repro_torch.launch.train`` is the training
entry point; ``chip_smoke.py`` at the repository root drives it on the card.
"""
