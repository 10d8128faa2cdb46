from .similarity import l2norm
