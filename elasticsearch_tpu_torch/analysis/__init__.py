from .analyzers import StandardAnalyzer, Token, get_analyzer

__all__ = ["StandardAnalyzer", "Token", "get_analyzer"]
