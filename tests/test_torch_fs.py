"""The port's write pipe: a pipeline that exits before it reads its input
fails at close with the pipe's ``RuntimeError``, never a stray
``BrokenPipeError`` (which one surfaced used to depend on whether the shell
had exited by the time the buffered text was flushed)."""

import pytest

from paddlebox_tpu_torch.utils.fs import fs_open_write


@pytest.mark.parametrize("status", [0, 3])
def test_pipe_that_exits_before_reading_fails_at_close(tmp_path, status):
    f = fs_open_write(str(tmp_path / "y.txt"), converter=f"exit {status}")
    f.proc.wait()  # the shell has exited: the flush at close finds no reader
    f.write("z\n")
    with pytest.raises(RuntimeError, match="pipe command failed"):
        f.close()
