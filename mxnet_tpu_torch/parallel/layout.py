"""SpecLayout: per-parameter partition specs for transformer blocks on a
named dp x fsdp x tp mesh (port of ``mxnet_tpu/parallel/layout.py``).

The rule table is ``mxnet_tpu``'s letter for letter, over gluon's Dense
weight convention ``W: (units_out, in_units)``:

- QKV / FFN-up projections are column-parallel: ``P(tp, fsdp)``;
- attention-output / FFN-down projections are row-parallel:
  ``P(fsdp, tp)``;
- the embedding and LM-head tables shard their vocab rows over
  ``(fsdp, tp)``;
- the column-parallel biases follow their weight's output split (``tp``),
  and everything else replicates.

The port has no ``jax.sharding.PartitionSpec``, so :class:`PartitionSpec`
is a tuple of the same form: one entry per leading dimension, each None
(replicated), an axis name or a tuple of names, trailing Nones dropped.
``ShardedTrainer`` consumes ``param_rules()`` as ``(regex, spec)`` pairs,
first match wins, unmatched parameters replicate. On a mesh without 'tp'
(:meth:`SpecLayout.for_mesh` drops the axes a mesh lacks) the rules name
only 'fsdp': fully sharded data parallelism. Rules naming 'tp' are
tensor parallelism (:mod:`tensor_parallel`): the trainer runs the
transformer's projections column- and row-parallel on each rank's shards
and gathers the embedding and head tables.
"""
from __future__ import annotations

__all__ = ["SpecLayout", "PartitionSpec", "P"]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` as a tuple: ``PartitionSpec('tp',
    None)``, one entry per leading dimension (None, an axis name or a
    tuple of names; a tuple of one name is that name, as JAX has it)."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class SpecLayout:
    """Assigns PartitionSpecs to gluon transformer parameters.

    ``data_axis``/``fsdp_axis``/``tp_axis`` name the mesh axes; pass
    None (or use :meth:`for_mesh`) to drop an axis the mesh doesn't
    have — the layout then degrades gracefully (dp-only meshes get pure
    data parallelism with replicated params, dp×fsdp meshes sharded
    parameters, and so on).
    """

    def __init__(self, data_axis="dp", fsdp_axis="fsdp", tp_axis="tp"):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis

    @classmethod
    def for_mesh(cls, mesh, data_axis="dp", fsdp_axis="fsdp",
                 tp_axis="tp"):
        """A SpecLayout with every axis the mesh lacks dropped to None."""
        names = set(mesh.axis_names)
        return cls(data_axis=data_axis if data_axis in names else None,
                   fsdp_axis=fsdp_axis if fsdp_axis in names else None,
                   tp_axis=tp_axis if tp_axis in names else None)

    # ----------------------------------------------------------- specs
    def _spec(self, *dims):
        """Build a PartitionSpec, collapsing dropped axes to None."""
        out = []
        for d in dims:
            if isinstance(d, tuple):
                kept = tuple(a for a in d if a is not None)
                out.append(kept if kept else None)
            else:
                out.append(d)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def qkv_projection(self):
        """(3·units, units) column-parallel: heads split over tp."""
        return self._spec(self.tp_axis, self.fsdp_axis)

    def attn_output(self):
        """(units, units) row-parallel: contraction dim over tp."""
        return self._spec(self.fsdp_axis, self.tp_axis)

    def ffn_up(self):
        """(4·units, units) column-parallel."""
        return self._spec(self.tp_axis, self.fsdp_axis)

    def ffn_down(self):
        """(units, 4·units) row-parallel."""
        return self._spec(self.fsdp_axis, self.tp_axis)

    def embedding(self):
        """(vocab, units) vocab rows over the full parameter surface."""
        return self._spec((self.fsdp_axis, self.tp_axis), None)

    def lm_head(self):
        """(vocab, units) — same table shape as the embedding."""
        return self._spec((self.fsdp_axis, self.tp_axis), None)

    def column_bias(self):
        """Bias of a column-parallel projection follows its out split."""
        return self._spec(self.tp_axis)

    def replicated(self):
        return self._spec()

    # ------------------------------------------------------ rule table
    def param_rules(self):
        """Ordered (regex, PartitionSpec) rules for ShardedTrainer,
        written against the model zoo transformer's parameter suffixes;
        first match wins and anything unmatched replicates."""
        return (
            (r".*attn_qkv_weight$", self.qkv_projection()),
            (r".*attn_qkv_bias$", self.column_bias()),
            (r".*attn_out_weight$", self.attn_output()),
            (r".*ff1_weight$", self.ffn_up()),
            (r".*ff1_bias$", self.column_bias()),
            (r".*ff2_weight$", self.ffn_down()),
            (r".*embed_weight$", self.embedding()),
            (r".*head_weight$", self.lm_head()),
        )

    # ------------------------------------------------------ batch side
    def batch_axes(self):
        """Mesh axes the batch dim shards over: dp and (flat-data) fsdp."""
        return tuple(a for a in (self.data_axis, self.fsdp_axis)
                     if a is not None)

    def batch_spec(self):
        """PartitionSpec for (B, ...) batches: dim 0 over dp×fsdp."""
        return self._spec(self.batch_axes())

    def __repr__(self):
        return (f"SpecLayout(data={self.data_axis!r}, "
                f"fsdp={self.fsdp_axis!r}, tp={self.tp_axis!r})")
