"""Plain NumPy references, one a module, named by a configuration's ``reference``."""
