__version__ = "0.1.0"
__author__ = "pyrodigal_tpu developers"
