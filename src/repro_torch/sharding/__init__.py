from .annotate import NULL_SHARDER, NullSharder, Sharder, profile_for

__all__ = ["NULL_SHARDER", "NullSharder", "Sharder", "profile_for"]
