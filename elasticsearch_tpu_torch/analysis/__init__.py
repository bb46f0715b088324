from .analyzers import (ENGLISH_STOP_WORDS, Analyzer, KeywordAnalyzer, SimpleAnalyzer,
                        StandardAnalyzer, StopAnalyzer, Token, WhitespaceAnalyzer, get_analyzer)

__all__ = ["Analyzer", "ENGLISH_STOP_WORDS", "KeywordAnalyzer", "SimpleAnalyzer",
           "StandardAnalyzer", "StopAnalyzer", "Token", "WhitespaceAnalyzer", "get_analyzer"]
