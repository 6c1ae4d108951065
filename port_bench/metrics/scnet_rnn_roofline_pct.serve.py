"""scnet_rnn_roofline_pct: the summed bound (operations at the bf16 peak,
bytes at 3.35 TB/s; ``scnet_work.recurrence_work``) of the LSTM
recurrences the window's dual-path layers ran, at their shapes, / the
device time of the recurrence's kernels in the trace, in %.  Those are
cuDNN's per-step kernels as the card names them: the cell update
(``elemWiseRNNcell``) and the step's product ``h·W_hhᵀ`` (cuBLAS's
``nvjet`` kernels at the shapes of the cell's LSTM calls, named in full);
the input side's one product a call and the Linear after it are left
out.  In the SCNet cell nothing outside the LSTM calls launches these
kernels (a card test holds that over an eager group of 2 and of 4
chunks).  The launches are the program's ``dual_path`` counter, held
against the driver's copy of the group schedule; None where it is absent
(a program without SCNet)."""

from port_bench import roformer_share

# the cell update; the step products of a group of 4 (time path at 256 and
# 512, frequency path) and of 2 chunks (likewise), as an H100 names them
FRAGMENTS = ("elemWiseRNNcell",
             "nvjet_tst_64x72_64x12_4x2_h_bz_TNT",
             "nvjet_tst_64x88_64x11_2x1_v_bz_TNT",
             "nvjet_tst_128x120_64x6_1x2_h_bz_TNT",
             "nvjet_tst_40x64_64x16_4x1_v_bz_TNN",
             "nvjet_tst_48x64_64x15_2x1_v_bz_TNN",
             "nvjet_tst_64x120_64x9_2x1_v_bz_TNT")


def read(run):
    return roformer_share.read(run, "dual_path", FRAGMENTS)
