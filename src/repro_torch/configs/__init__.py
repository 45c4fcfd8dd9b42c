"""Model configurations (counterpart of ``repro.configs``).

This slice holds smollm-360m's ``LMConfig`` alone; ``configs/base.py``,
the registry of architectures and the other configurations come with the
port's launchers (ROADMAP Queue A item 9).
"""
