"""Training in one process (the reference's ``train/`` package, its host
path): AdamW written out, int8 gradient compression with error feedback,
checkpoints, the train step, the redundant shard plan of Lemma 3, elastic
group management and the trainer."""
