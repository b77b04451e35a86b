"""Tokenizers of the port: the CLIP byte-level BPE (clip_bpe.py) and the T5
SentencePiece unigram reader (spm.py), both pure Python."""
