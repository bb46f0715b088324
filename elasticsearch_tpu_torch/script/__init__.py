"""Scripts: the expression language (`expression.compile_script`), runtime
fields (`runtime.py`) and update scripts (`update.UpdateScript`)."""
