"""The reference's copies of scenes beyond ``scenes.FACTORIES``, one file a
scene: ``<name>.py`` defines ``build(use_bvh=True)`` returning (SceneArrays
on the CPU, default Light, camera kwargs), as the factories of
``scenes.py`` do, and ``scenes.load_scene(<name>)`` finds it."""
