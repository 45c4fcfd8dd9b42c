# IR substrate: tokenization, synthetic corpora, inverted index + BM25,
# dense retrieval.
from .tokenizer import WordTokenizer, HashTokenizer, fnv1a32
from .corpus import SyntheticCorpus, make_corpus, msmarco_like
from .index import InvertedIndex, BM25Retriever, TextLoader, QueryExpander
from .dense import DenseEncoder, DenseIndex, DenseRetriever

__all__ = ["WordTokenizer", "HashTokenizer", "fnv1a32", "SyntheticCorpus",
           "make_corpus", "msmarco_like", "InvertedIndex", "BM25Retriever",
           "TextLoader", "QueryExpander", "DenseEncoder", "DenseIndex",
           "DenseRetriever"]
