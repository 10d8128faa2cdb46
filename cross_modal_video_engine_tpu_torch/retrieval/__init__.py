from .index import RetrievalIndex
