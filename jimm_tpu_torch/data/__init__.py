"""Data: synthetic datasets, NaFlex batching, file readers and writers
(TFRecord, WebDataset), preprocessing, the CLIP tokenizer."""
