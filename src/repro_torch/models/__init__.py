"""The model of the port: the language models (``lm``) of dense GQA, MLA,
MoE, Mamba-2 and RG-LRU layers, their building blocks (``layers``,
``attention``, ``mla``, ``moe``, ``ssm``, ``rglru``) and the weight bridge
from the JAX package's flat parameters (``bridge``)."""
