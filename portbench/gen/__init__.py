"""Input generators, one a module, named by a configuration's ``generator``."""
