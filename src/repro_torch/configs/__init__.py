"""Model configurations (counterpart of ``repro.configs``).

This package holds the ``CONFIG`` of smollm-360m, the four recsys models
(dlrm-rm2, dcn-v2, mind, two-tower-retrieval) and gcn-cora, with the
reference's values; ``configs/base.py``, the registry of architectures
(``ARCH``) and the other LM configurations come with the port's
launchers (ROADMAP Queue A).
"""
