"""Data-parallel training over ``torch.distributed``: one process a card (or
a few processes sharing one), envs sharded by rows, the learner replicated.

``distributed`` joins the process group and splits env rows; ``sharding``
keeps a rank's rows of env trees and params and replicates trainer state;
``draws`` makes every random draw of a rank the rows of the draw one
process would make for all envs, so P ranks compute what one process does.
"""
