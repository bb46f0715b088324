from .coalesce import term_disjunction_of

__all__ = ["term_disjunction_of"]
