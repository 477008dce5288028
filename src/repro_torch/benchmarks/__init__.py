"""The paper-table benchmarks on the port (counterpart of the reference's
top-level ``benchmarks/``): ``common.run_distributed`` and the MLP harness,
one driver per paper table or ablation, and ``run`` to drive them.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --fast [--only ...]
"""
