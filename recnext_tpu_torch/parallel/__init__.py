"""Multi-process data parallelism (``sharding.py``) and replicated inference
(``serving.py``)."""
