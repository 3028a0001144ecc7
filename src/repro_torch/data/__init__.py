from .pipeline import DataConfig, FileSource, SyntheticTokenSource

__all__ = ["DataConfig", "FileSource", "SyntheticTokenSource"]
