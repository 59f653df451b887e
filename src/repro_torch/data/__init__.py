from .synthetic import (  # noqa: F401
    Batches, ClsDataConfig, make_classification, split_forget_retain)
