"""Data of the federated round: synthetic datasets, Non-IID partitions, client shards."""
