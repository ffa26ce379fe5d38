"""The model of the port: dense GQA language models (``lm``), their
building blocks (``layers``, ``attention``) and the weight bridge from the
JAX package's flat parameters (``bridge``)."""
