"""Workflow and config files for the port's GA tests (wine, small).

Not a test module: ``test_torch_ga_*.py`` import it.  Each writer puts
a file into a test's ``tmp_path`` and returns its path.
"""

import os
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = "wine.layers[0]['<-']['learning_rate']"
WIDTH = "wine.layers[0]['->']['output_sample_shape']"

#: wine through create_workflow; $GA_TEST_DIE_ABOVE kills the evaluator
#: (os._exit) for a genome whose lr is above it, every time, and
#: $GA_TEST_DIE_ONCE_MARKER once, for an lr in (0.5, 0.6), leaving the
#: marker file; $GA_TEST_HANG_ABOVE makes such a genome sleep for a
#: minute instead; $GA_TEST_COHORT_FAILS makes every batched (P > 1)
#: cohort fail ("oom": as a CUDA out-of-memory error), or every cohort
#: ("all")
WORKFLOW = textwrap.dedent("""
    import os
    import time

    import torch

    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import wine
    from veles_tpu_torch.ops import population

    _mode = os.environ.get("GA_TEST_COHORT_FAILS")
    if _mode and not getattr(population, "_test_patched", False):
        _run = population.PopulationTrainEngine.run

        def _failing_run(self):
            if _mode == "all" or self.n_members > 1:
                if _mode == "oom":
                    raise torch.cuda.OutOfMemoryError("test: no memory")
                raise RuntimeError("test: cohort path down")
            return _run(self)
        population.PopulationTrainEngine.run = _failing_run
        population._test_patched = True


    def create_workflow(launcher):
        lr = root.wine.layers[0]["<-"]["learning_rate"]
        above = os.environ.get("GA_TEST_DIE_ABOVE")
        if above is not None and lr > float(above):
            os._exit(3)
        above = os.environ.get("GA_TEST_HANG_ABOVE")
        if above is not None and lr > float(above):
            time.sleep(60)
        marker = os.environ.get("GA_TEST_DIE_ONCE_MARKER")
        if marker and 0.5 < lr < 0.6 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(3)
        return wine.create_workflow(launcher)


    def run(launcher):
        launcher.create_workflow(create_workflow)
        launcher.initialize()
        launcher.run()
""")

#: the genes: the first layer's width (an integer: splits cohorts) and
#: its learning rate (liftable); ``{epochs}`` a genome
CONFIG = textwrap.dedent("""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import Tune

    root.wine.decision = {{"max_epochs": {epochs}}}
    root.wine.layers = [
        {{"type": "all2all_tanh",
          "->": {{"output_sample_shape": {width}}},
          "<-": {{"learning_rate": Tune(0.3, 0.01, 1.0)}}}},
        {{"type": "softmax", "->": {{"output_sample_shape": 3}},
          "<-": {{"learning_rate": 0.3}}}},
    ]
""")

#: appended to a config: SIGTERM to the GA parent right after it saved
#: generation 1's state, once ($GA_TEST_SIGTERM_MARKER)
SIGTERM_HOOK = textwrap.dedent("""
    import os
    import signal

    from veles_tpu_torch.genetics import core as _core

    if not getattr(_core, "_test_hooked", False):
        _save = _core.GeneticOptimizer._save_state

        def _save_then_signal(self, gen, pop, fits):
            _save(self, gen, pop, fits)
            marker = os.environ.get("GA_TEST_SIGTERM_MARKER")
            if gen == 1 and marker and not os.path.exists(marker):
                open(marker, "w").close()
                os.kill(os.getpid(), signal.SIGTERM)
        _core.GeneticOptimizer._save_state = _save_then_signal
        _core._test_hooked = True
""")


def write_files(tmp_path, epochs=2, tune_width=True, sigterm=False):
    """(workflow file, config file) under ``tmp_path``."""
    wf = tmp_path / "wf.py"
    wf.write_text(WORKFLOW)
    cfg = tmp_path / "cfg.py"
    width = "Tune(8, 4, 16)" if tune_width else "8"
    text = CONFIG.format(epochs=epochs, width=width)
    if sigterm:
        text += SIGTERM_HOOK
    cfg.write_text(text)
    return str(wf), str(cfg)
