from .ciderd import CiderScorer, cut_at_eos, load_df_pickle, ngram_counts

__all__ = ["CiderScorer", "cut_at_eos", "load_df_pickle", "ngram_counts"]
