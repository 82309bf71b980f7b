"""scene.compile_s: the program's SceneBuilder.build in set-up (the
mesh is the benchmark's), on the harness's clock."""


def read(run):
    return run.scene_compile_s
