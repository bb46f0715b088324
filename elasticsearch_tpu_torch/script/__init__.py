"""Scripts: the expression language (`expression.compile_script`)."""
